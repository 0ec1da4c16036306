// Attention on pre-marshaled quad operands (forward) for Hopper.
//
// Replaces tools/attn_variants.py: kern_quad_pre (:438), launched by
// run_quad_pre (:475), a TPU probe of the two-products-per-head structure
// of eight windows: per block i of 392 rows and head h, with qb
// [nq, nH, 392, 128], kb [nq, nH, 2, 98, 128] (bf16) and bias
// [nH, 392, 98] (fp32),
//   S  = qb[i, h] kb[i, h, 0]^T               fp32, no scale
//   P  = bf16(softmax(S + bias[h]))           over the 98 keys
//   O  = P kb[i, h, 1]                        [392, 128], fp32
//   out[i, :, 32 h + d] = bf16(O[:, d] + O[:, 32 + d] + O[:, 64 + d]
//                              + O[:, 96 + d])     summed in that order
// (the head width 32 is the probe's own). The row and key counts are
// arguments here; the probe's are 392 and 98.
//
// What bounds it: per (block, head) 2 * 392 * 98 * 128 multiply-adds for
// 156 KB of operands, ~64 FLOP a byte: below the card's bf16 ridge, above
// its fp32 one; this first version runs the products as fp32 FMA from
// shared memory, so the CUDA cores' fp32 rate bounds it. Design: one
// block per (i, h); K and V of the head staged in shared memory as fp32
// (K rows padded to 129 against bank conflicts), the 392 rows walked in
// chunks of 56: q rows staged, scores with bias, a warp per row for the
// softmax, then P V with the four 32-lane blocks summed per output.
// Tensor cores are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kD = 128;        // lanes of qb and kb
constexpr int kHd = 32;        // output columns per head
constexpr int kChunkRows = 56;
constexpr int kLdK = kD + 1;   // padded row of q and K in shared memory

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// rows x 128 bf16 (row stride 128) -> fp32 rows of stride ld
__device__ __forceinline__ void stage(float* dst, int ld,
                                      const __nv_bfloat16* src, int rows) {
  for (int i = threadIdx.x; i < rows * (kD / 8); i += blockDim.x) {
    const int r = i / (kD / 8), c = (i - r * (kD / 8)) * 8;
    const uint4 u = *reinterpret_cast<const uint4*>(src + (size_t)r * kD + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * ld + c + j] = __bfloat162float(e[j]);
  }
}

size_t quad_smem(int nk) {
  return sizeof(float) * ((size_t)nk * kLdK + (size_t)nk * kD +
                          (size_t)kChunkRows * kLdK +
                          (size_t)kChunkRows * (nk + 1));
}

__global__ void __launch_bounds__(kThreads)
quad_attn_fwd_kernel(const __nv_bfloat16* __restrict__ qb,
                     const __nv_bfloat16* __restrict__ kb,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int nH, int Rq, int Nk) {
  extern __shared__ float smem[];
  const int i = blockIdx.x, h = blockIdx.y;
  const int lds = Nk + 1;
  float* ks = smem;
  float* vs = ks + (size_t)Nk * kLdK;
  float* qs = vs + (size_t)Nk * kD;
  float* ss = qs + (size_t)kChunkRows * kLdK;
  const size_t ih = (size_t)i * nH + h;
  stage(ks, kLdK, kb + ih * 2 * Nk * kD, Nk);
  stage(vs, kD, kb + (ih * 2 + 1) * Nk * kD, Nk);
  const float* bh = bias + (size_t)h * Rq * Nk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int r0 = 0; r0 < Rq; r0 += kChunkRows) {
    const int rows = min(kChunkRows, Rq - r0);
    __syncthreads();  // the previous chunk's scores and q are consumed
    stage(qs, kLdK, qb + (ih * Rq + r0) * kD, rows);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * Nk; e += blockDim.x) {
      const int r = e / Nk, c = e - r * Nk;
      const float* qr = qs + r * kLdK;
      const float* kc = ks + c * kLdK;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < kD; ++d) acc = fmaf(qr[d], kc[d], acc);
      ss[r * lds + c] = acc + bh[(size_t)(r0 + r) * Nk + c];
    }
    __syncthreads();
    for (int r = warp; r < rows; r += blockDim.x / 32) {
      float* row = ss + r * lds;
      float m = -INFINITY;
      for (int c = lane; c < Nk; c += 32) m = fmaxf(m, row[c]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lane; c < Nk; c += 32) {
        const float e = expf(row[c] - m);
        row[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < Nk; c += 32)
        row[c] = __bfloat162float(__float2bfloat16(row[c] / sum));
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * kHd; e += blockDim.x) {
      const int r = e / kHd, d = e - r * kHd;
      const float* pr = ss + r * lds;
      float o0 = 0.f, o1 = 0.f, o2 = 0.f, o3 = 0.f;
      for (int c = 0; c < Nk; ++c) {
        const float p = pr[c];
        const float* vc = vs + c * kD + d;
        o0 = fmaf(p, vc[0], o0);
        o1 = fmaf(p, vc[kHd], o1);
        o2 = fmaf(p, vc[2 * kHd], o2);
        o3 = fmaf(p, vc[3 * kHd], o3);
      }
      out[((size_t)i * Rq + r0 + r) * nH * kHd + h * kHd + d] =
          __float2bfloat16(((o0 + o1) + o2) + o3);
    }
  }
}

}  // namespace

// qb [nq, nH, Rq, 128], kb [nq, nH, 2, Nk, 128] (bf16), bias [nH, Rq, Nk]
// (fp32) -> out [nq, Rq, 32 nH] (bf16); Nk <= 128.
extern "C" int mtlora_quad_attn_fwd(const void* qb, const void* kb,
                                    const void* bias, void* out, int nq,
                                    int nH, int Rq, int Nk, void* stream) {
  if (nq < 1 || nH < 1 || Rq < 1 || Nk < 1 || Nk > kD)
    return (int)cudaErrorInvalidValue;
  const size_t smem = quad_smem(Nk);
  cudaError_t e = cudaFuncSetAttribute(
      quad_attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  quad_attn_fwd_kernel<<<dim3(nq, nH), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qb),
      static_cast<const __nv_bfloat16*>(kb), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), nH, Rq, Nk);
  return (int)cudaGetLastError();
}
