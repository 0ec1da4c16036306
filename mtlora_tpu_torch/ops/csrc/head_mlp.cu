// Fused HRNet decode head (forward) for Hopper:
//   y = bf16( relu( bf16( bf16(x @ We + be) * mul ) + add ) @ Wp + bp )
// with x @ We and z @ Wp accumulated in fp32, the BN affine (mul, add:
// folded from the running statistics outside) computed in bf16, and the
// output rounded to bf16.
//
// Replaces mtlora_tpu/ops/pallas_head.py: _fwd_kernel, launched by
// _run_fwd through fused_head_mlp.
//
// What bounds it: per row, 270 -> 1080 -> n (n <= 21) is ~2 * 0.3 MFLOP
// against 540 bytes of input, far above the card's ~295 FLOP/byte ridge,
// so the kernel is bound by tensor-core throughput and by how well it
// feeds it; the TPU kernel's win, which this one keeps, is that the
// [M, 1080] hidden (217 MB in bf16 at batch 32) never reaches HBM.
// Design: one block of 4 warps per 64 rows; the block's x tile stays in
// shared memory; the hidden dimension is walked in chunks of 64 columns
// (the whole [64, 1080] hidden in fp32 would be 276 KB, above the 227 KB
// of shared memory): each chunk's We^T slice is staged in shared memory,
// each warp computes its 16 x 64 hidden tile with mma.sync m16n8k16
// (bf16 in, fp32 accumulate), applies bias, BN affine and ReLU, writes the
// bf16 z tile to shared memory and multiplies it into the [16, n]
// output accumulators that stay in registers across chunks. Odd widths
// (270 inputs, n in {1, 3, 7, 21}) are zero-padded in shared memory and
// the stores are masked. Weights are read transposed, [1080, 270] and
// [n, 1080], which is the layout of the 1x1 conv weights, so the
// fragments load as 32-bit pairs along k. No TMA, wgmma or pipelining
// yet: those are a later version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBM = 64;     // rows per block
constexpr int kHC = 64;     // hidden columns per chunk
constexpr int kWarps = 4;   // 16 rows each
constexpr int kNMax = 64;   // outputs: at most 8 n-tiles of 8
constexpr int kZld = kHC + 8;

__global__ void __launch_bounds__(kWarps * 32)
head_mlp_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ ek_t,
                    const float* __restrict__ eb,
                    const float* __restrict__ mul,
                    const float* __restrict__ add,
                    const __nv_bfloat16* __restrict__ pk_t,
                    const float* __restrict__ pb,
                    __nv_bfloat16* __restrict__ y,
                    int M, int cin, int hidden, int n_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Kp = (cin + 15) / 16 * 16;
  const int xld = Kp + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* es = xs + kBM * xld;
  __nv_bfloat16* zs = es + kHC * xld;
  __nv_bfloat16* ps = zs + kBM * kZld;
  float* ebs = reinterpret_cast<float*>(ps + kNMax * kZld);
  float* muls = ebs + kHC;
  float* adds = muls + kHC;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = blockIdx.x * kBM;
  const int NT = (n_out + 7) / 8;
  const int kw = Kp / 2;   // 32-bit words per padded row
  const int cw = cin / 2;  // 32-bit words per input row
  const int hw = hidden / 2;

  // ---- x tile, zero-padded rows and columns -------------------------------
  const uint32_t* xg = reinterpret_cast<const uint32_t*>(x);
  for (int i = tid; i < kBM * kw; i += nthreads) {
    const int r = i / kw;
    const int c = i - r * kw;
    const int gr = row0 + r;
    uint32_t val = 0;
    if (gr < M && c < cw) val = xg[(size_t)gr * cw + c];
    reinterpret_cast<uint32_t*>(xs + r * xld)[c] = val;
  }

  float out[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nt][e] = 0.f;

  const uint32_t* eg = reinterpret_cast<const uint32_t*>(ek_t);
  const uint32_t* pg = reinterpret_cast<const uint32_t*>(pk_t);
  const int wr0 = warp * 16;

  for (int j0 = 0; j0 < hidden; j0 += kHC) {
    __syncthreads();  // previous chunk fully consumed
    for (int i = tid; i < kHC * kw; i += nthreads) {
      const int jr = i / kw;
      const int c = i - jr * kw;
      const int gj = j0 + jr;
      uint32_t val = 0;
      if (gj < hidden && c < cw) val = eg[(size_t)gj * cw + c];
      reinterpret_cast<uint32_t*>(es + jr * xld)[c] = val;
    }
    for (int i = tid; i < NT * 8 * (kHC / 2); i += nthreads) {
      const int o = i / (kHC / 2);
      const int c = i - o * (kHC / 2);
      const int gj = j0 + 2 * c;
      uint32_t val = 0;
      if (o < n_out && gj < hidden) val = pg[(size_t)o * hw + j0 / 2 + c];
      reinterpret_cast<uint32_t*>(ps + o * kZld)[c] = val;
    }
    for (int i = tid; i < kHC; i += nthreads) {
      const int gj = j0 + i;
      const bool in = gj < hidden;
      ebs[i] = in ? eb[gj] : 0.f;
      muls[i] = in ? round_bf16(mul[gj]) : 0.f;
      adds[i] = in ? round_bf16(add[gj]) : 0.f;
    }
    __syncthreads();

    // ---- h = x @ We (this warp's 16 rows x 64 hidden columns) -------------
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    for (int kk = 0; kk < Kp; kk += 16) {
      uint32_t a[4];
      load_a(a, xs + wr0 * xld + kk, xld, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* b = es + (nt * 8 + g) * xld + kk + 2 * t;
        mma_bf16_16816(acc[nt], a, ld32(b), ld32(b + 8));
      }
    }

    // ---- bias, bf16 BN affine, ReLU -> z tile in shared memory ------------
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wr0 + g + half * 8;
        const int col = nt * 8 + 2 * t;
        float z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = col + e;
          const float hc = round_bf16(acc[nt][half * 2 + e] + ebs[j]);
          const float zp = round_bf16(round_bf16(hc * muls[j]) + adds[j]);
          z[e] = (j0 + j < hidden) ? fmaxf(zp, 0.f) : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(zs + r * kZld + col) =
            __floats2bfloat162_rn(z[0], z[1]);
      }
    }
    __syncwarp();

    // ---- out += z @ Wp -----------------------------------------------------
#pragma unroll
    for (int kk = 0; kk < kHC; kk += 16) {
      uint32_t a[4];
      load_a(a, zs + wr0 * kZld + kk, kZld, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < NT) {
          const __nv_bfloat16* b = ps + (nt * 8 + g) * kZld + kk + 2 * t;
          mma_bf16_16816(out[nt], a, ld32(b), ld32(b + 8));
        }
      }
    }
  }

  // ---- y = bf16(out + bp), masked stores ----------------------------------
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (nt < NT) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wr0 + g + (e >= 2 ? 8 : 0);
        const int col = nt * 8 + 2 * t + (e & 1);
        if (r < M && col < n_out)
          y[(size_t)r * n_out + col] = __float2bfloat16(out[nt][e] + pb[col]);
      }
    }
  }
}

}  // namespace

extern "C" int mtlora_head_mlp_fwd(const void* x, const void* ek_t,
                                   const void* eb, const void* mul,
                                   const void* add, const void* pk_t,
                                   const void* pb, void* y, int M, int cin,
                                   int hidden, int n_out, void* stream) {
  if (n_out < 1 || n_out > kNMax || (cin & 1) || (hidden & 1))
    return (int)cudaErrorInvalidValue;
  const int Kp = (cin + 15) / 16 * 16;
  const size_t smem = sizeof(__nv_bfloat16) *
                          ((size_t)(kBM + kHC) * (Kp + 8) +
                           (size_t)(kBM + kNMax) * kZld) +
                      sizeof(float) * 3 * kHC;
  cudaError_t e = cudaFuncSetAttribute(
      head_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (M + kBM - 1) / kBM;
  head_mlp_fwd_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(ek_t), static_cast<const float*>(eb),
      static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<const __nv_bfloat16*>(pk_t), static_cast<const float*>(pb),
      static_cast<__nv_bfloat16*>(y), M, cin, hidden, n_out);
  return (int)cudaGetLastError();
}
