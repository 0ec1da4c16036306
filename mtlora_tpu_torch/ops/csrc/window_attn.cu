// Window attention core (forward), the first port's kernel, kept for the
// probes.
//
// Replaced mtlora_tpu/ops/pallas_window_attn.py: _fwd_kernel, launched by
// _run_fwd through fused_window_attention_windowed. Per window w and head
// h:
//   out[w, :, h] = softmax(q*scale @ k^T + bias[h] + mask[w % nW]) @ v
// with q*scale rounded to bf16, fp32 scores, bias, mask and softmax, P
// rounded to bf16 and P@V accumulated in fp32. Kernels 1 and 1c now run
// on tensor cores (window_attn_fwd.cu); this source's body stays as the
// instrument of the probes below, and its kFull mode as probe P1 (the
// same function as kernel 1).
//
// Design: one block per (window, head); q, k and v of the head go to
// shared memory as fp32 (rows padded to hd + 1 to avoid bank conflicts),
// the N x N scores stay in shared memory, softmax runs one warp per row,
// and both products are plain FMA loops. It reads the plain
// [B*nW, N, 3C] window order with 16-byte loads.
//
// The probes of tools/attn_probe.py (_kern :30, launched by run :85) and
// tools/attn_variants.py (kern_dots_only :78 and kern_softmax_only :96,
// launched by run_variant :513) are kernel 1's body with a part switched,
// a template parameter of attend and of kernel 1's window_attn_fwd_kernel,
// one block per (window, head):
//   kFull         kernel 1;
//   kNoSmax       P = bf16(S) in place of the softmax;
//   kNoDots       S = bf16(q[:, 0] + k[:, 0]^T) (unscaled, broadcast over
//                 the row) in place of q k^T, then bias, mask, softmax, PV;
//   kDotsOnly     (q*scale k^T) V: no bias, mask or softmax;
//   kSoftmaxOnly  the row sums of softmax(x[:, 0] + bias[h]) (x[:, 0] the
//                 window's first qkv column, the same for every head),
//                 written to the columns c = h (mod nH) of the output, as
//                 the probe's `outs * (C // nH)` repeats the heads.
// The TPU ran these bodies on pack-2 window pairs behind a -1e9 block
// bias; without a softmax (kNoSmax, kDotsOnly) that layout mixes the two
// windows, so the port computes each body per 49-token window, the
// function that the JAX bodies compute on unpacked windows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The modes' ids, which window_attn.py's PROBE_MODES names (kFull is
// kernel 1).
enum Mode { kFull = 0, kNoSmax = 1, kNoDots = 2, kDotsOnly = 3,
            kSoftmaxOnly = 4 };

// One (window, head): q, k, v of head h of window w to shared memory,
// scores + bias bh + mask mw (null: none), softmax, P @ V to out; with
// MODE a part switched (see above). The caller orders this call after any
// earlier use of the shared memory.
template <int MODE = kFull>
__device__ __forceinline__ void attend(const __nv_bfloat16* __restrict__ qkv,
                                       const float* __restrict__ bh,
                                       const float* __restrict__ mw,
                                       __nv_bfloat16* __restrict__ out,
                                       float* smem, int w, int h, int N,
                                       int C, int hd, float scale) {
  const int ld = hd + 1;
  const int lds = N + 1;
  float* q = smem;
  float* k = q + N * ld;
  float* v = k + N * ld;
  float* s = v + N * ld;

  if constexpr (MODE == kSoftmaxOnly) {
    // s[r][c] = x[w, r, 0] + bias[h][r][c]; one warp per row
    const __nv_bfloat16* xw = qkv + (size_t)w * N * 3 * C;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nH = C / hd;
    for (int r = warp; r < N; r += blockDim.x / 32) {
      const float x0 = __bfloat162float(xw[(size_t)r * 3 * C]);
      float m = -INFINITY;
      for (int c = lane; c < N; c += 32) m = fmaxf(m, x0 + bh[r * N + c]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lane; c < N; c += 32) sum += expf(x0 + bh[r * N + c] - m);
      sum = warp_sum(sum);
      float rs = 0.f;
      for (int c = lane; c < N; c += 32)
        rs += expf(x0 + bh[r * N + c] - m) / sum;
      rs = warp_sum(rs);
      const __nv_bfloat16 o = __float2bfloat16(rs);
      __nv_bfloat16* orow = out + ((size_t)w * N + r) * C;
      for (int j = lane; j < hd; j += 32) orow[h + j * nH] = o;
    }
    return;
  }

  // ---- load q (scaled, rounded to bf16), k, v of head h -------------------
  const __nv_bfloat16* base = qkv + (size_t)w * N * 3 * C + h * hd;
  const int vecs = hd / 8;  // 16-byte vectors per row and part
  for (int i = threadIdx.x; i < N * 3 * vecs; i += blockDim.x) {
    const int row = i / (3 * vecs);
    const int rem = i - row * 3 * vecs;
    const int part = rem / vecs;
    const int c = rem - part * vecs;
    const uint4 u = *reinterpret_cast<const uint4*>(
        base + (size_t)row * 3 * C + part * C + c * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
    float* dst = (part == 0 ? q : (part == 1 ? k : v)) + row * ld + c * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float f = __bfloat162float(e[j]);
      dst[j] = (part == 0 && MODE != kNoDots) ? round_bf16(f * scale) : f;
    }
  }
  __syncthreads();

  // ---- scores: fp32 dot + bias + mask -------------------------------------
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N;
    const int c = i - r * N;
    const float* qr = q + r * ld;
    const float* kc = k + c * ld;
    float acc = 0.f;
    if constexpr (MODE == kNoDots) {
      acc = round_bf16(qr[0] + kc[0]);
    } else {
      for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kc[d], acc);
    }
    if constexpr (MODE != kDotsOnly) {
      acc += bh[i];
      if (mw) acc += mw[i];
    }
    s[r * lds + c] = acc;
  }
  __syncthreads();

  // ---- fp32 softmax, one warp per row; P rounded to bf16 (no softmax:
  // P = bf16(S)) ----------------------------------------------------------
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if constexpr (MODE == kNoSmax || MODE == kDotsOnly) {
    for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
      const int r = i / N;
      s[r * lds + i - r * N] = round_bf16(s[r * lds + i - r * N]);
    }
  } else {
    for (int r = warp; r < N; r += blockDim.x / 32) {
      float* row = s + r * lds;
      float m = -INFINITY;
      for (int c = lane; c < N; c += 32) m = fmaxf(m, row[c]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lane; c < N; c += 32) {
        const float e = expf(row[c] - m);
        row[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int c = lane; c < N; c += 32) row[c] = round_bf16(row[c] / sum);
    }
  }
  __syncthreads();

  // ---- P @ V, fp32 accumulation, bf16 out ---------------------------------
  __nv_bfloat16* ob = out + (size_t)w * N * C + h * hd;
  for (int i = threadIdx.x; i < N * hd; i += blockDim.x) {
    const int r = i / hd;
    const int d = i - r * hd;
    const float* pr = s + r * lds;
    float acc = 0.f;
    for (int c = 0; c < N; ++c) acc = fmaf(pr[c], v[c * ld + d], acc);
    ob[(size_t)r * C + d] = __float2bfloat16(acc);
  }
}

__host__ __device__ size_t attend_smem(int N, int hd) {
  return sizeof(float) * (3 * (size_t)N * (hd + 1) + (size_t)N * (N + 1));
}

// The probes (kFull: kernel 1's function): one block per (window, head),
// bias and mask read in place.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
window_attn_fwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const float* __restrict__ bias,
                       const float* __restrict__ mask,
                       __nv_bfloat16* __restrict__ out,
                       int N, int C, int hd, int mask_windows, float scale) {
  extern __shared__ float smem[];
  const int w = blockIdx.x;
  const int h = blockIdx.y;
  attend<MODE>(qkv, bias + (size_t)h * N * N,
               mask ? mask + (size_t)(w % mask_windows) * N * N : nullptr,
               out, smem, w, h, N, C, hd, scale);
}

using FwdKernel = void (*)(const __nv_bfloat16*, const float*, const float*,
                          __nv_bfloat16*, int, int, int, int, float);

FwdKernel mode_kernel(int mode) {
  switch (mode) {
    case kFull: return window_attn_fwd_kernel<kFull>;
    case kNoSmax: return window_attn_fwd_kernel<kNoSmax>;
    case kNoDots: return window_attn_fwd_kernel<kNoDots>;
    case kDotsOnly: return window_attn_fwd_kernel<kDotsOnly>;
    case kSoftmaxOnly: return window_attn_fwd_kernel<kSoftmaxOnly>;
    default: return nullptr;
  }
}

}  // namespace

// A probe mode (a Mode; kFull: kernel 1's function), at qkv
// [n_windows, N, 3C] (bf16), bias [nH, N, N] and mask [mask_windows, N, N]
// (fp32, or null); kDotsOnly and kSoftmaxOnly take no mask.
extern "C" int mtlora_window_attn_fwd(int mode, const void* qkv,
                                      const void* bias, const void* mask,
                                      void* out, int n_windows, int N, int C,
                                      int num_heads, int mask_windows,
                                      float scale, void* stream) {
  const FwdKernel kern = mode_kernel(mode);
  if (!kern || (mask && (mode == kDotsOnly || mode == kSoftmaxOnly)))
    return (int)cudaErrorInvalidValue;
  const int hd = C / num_heads;
  const size_t smem = attend_smem(N, hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_windows, num_heads);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out), N,
      C, hd, mask_windows > 0 ? mask_windows : 1, scale);
  return (int)cudaGetLastError();
}
