// Window attention core (backward) for Hopper.
//
// Replaces mtlora_tpu/ops/pallas_window_attn.py: _bwd_kernel, launched by
// _run_bwd through the custom VJP of _fused_windows. Per window w and
// head h, P is recomputed exactly as the forward computes it (q*scale
// rounded to bf16 with the bf16 scale, fp32 scores + bias + mask, fp32
// softmax), kept in fp32, and
//   dv = P^T dO,  dP = dO v^T,  dS = P * (dP - rowsum(dP * P)),
//   dq = (dS k) * scale,  dk = dS^T (q * scale)   (fp32 q, fp32 scale),
//   dbias[h] = sum over every window of dS.
//
// What bounds it: per (window, head) five 49 x 49 x 32 products against
// 12.5 KB of bf16 in and 9.4 KB out, ~60 FLOP per byte, below the card's
// ridge; at these sizes the kernel is bound by latency and FMA issue
// rather than by either roof. The TPU kernel's win, kept here, is that
// the [windows, heads, 49, 49] P and dS never reach HBM.
//
// Design: one block per (group of windows, head). The head's bias is
// staged once in shared memory; for each window of the group, q (rounded
// and unrounded), k, v and dO go to shared memory in fp32 (rows padded to
// hd + 1), scores and dP are formed by one pass of FMA loops, softmax and
// dS run one warp per row, and dq, dk, dv come from one more pass. dS is
// summed over the group's windows in shared memory; every (row, column)
// is owned by one thread, so the sum has no race. Each block writes its
// [N, N] partial to [n_groups, nH, N, N], and a second kernel sums the
// groups in a fixed order: the result is deterministic, with no fp32
// atomics. The mask is indexed by window % nW, as in the forward.
//
// Kernel 1c's backward (the dense mode: _bwd_kernel with chunks = 4,
// launched by _run_bwd_dense) is the same kernel with groups of whole
// 8-window cells: each cell's mask tiles are staged in shared memory at
// its first window, the bias once per group as above, and the dbias
// partials, one per cell group, are summed in group order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// windows per dense cell (kernel 1c), as in window_attn.cu
constexpr int kCell = 8;

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

// kDense (kernel 1c): groups are whole cells of kCell windows, and the
// mask tiles of each cell's period positions are staged in shared memory
// at the cell's first window instead of being read per window.
template <bool kDense>
__global__ void __launch_bounds__(kThreads)
window_attn_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const float* __restrict__ bias,
                       const float* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dqkv,
                       float* __restrict__ dbias_part,
                       int n_windows, int group, int N, int C, int hd,
                       int mask_windows, float scale_c, float scale) {
  extern __shared__ float smem[];
  const int grp = blockIdx.x;
  const int h = blockIdx.y;
  const int nH = gridDim.y;
  const int ld = hd + 1;
  const int lds = N + 1;
  const int NN = N * N;
  float* qs = smem;            // bf16(q * bf16 scale): the scores' q
  float* qf = qs + N * ld;     // q * scale in fp32: dk's q
  float* k = qf + N * ld;
  float* v = k + N * ld;
  float* dO = v + N * ld;
  float* p = dO + N * ld;      // [N][lds] scores, then P
  float* ds = p + N * lds;     // [N][lds] dP, then dS
  float* bh = ds + N * lds;    // [N*N] bias of head h
  float* acc = bh + NN;        // [N*N] dS summed over the group
  float* ms = acc + NN;        // kDense: the cell's mask tiles
  const int tiles = (kDense && mask) ? min(kCell, mask_windows) : 0;

  const int tid = threadIdx.x;
  for (int i = tid; i < NN; i += blockDim.x) {
    bh[i] = bias[(size_t)h * NN + i];
    acc[i] = 0.f;
  }
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nwarps = blockDim.x / 32;
  const int vecs = hd / 8;  // 16-byte vectors per row and part
  const int w0 = grp * group;
  const int w1 = min(w0 + group, n_windows);

  for (int w = w0; w < w1; ++w) {
    __syncthreads();  // bias staged / previous window consumed
    if (kDense && tiles && (w - w0) % kCell == 0) {
      const int pos = w % mask_windows;
      for (int i = tid; i < tiles * NN; i += blockDim.x) {
        const int j = i / NN;
        ms[i] = mask[(size_t)((pos + j) % mask_windows) * NN + (i - j * NN)];
      }
    }

    // ---- q, k, v of head h and dO, as fp32 ------------------------------
    const __nv_bfloat16* base = qkv + (size_t)w * N * 3 * C + h * hd;
    const __nv_bfloat16* dbase = dout + (size_t)w * N * C + h * hd;
    for (int i = tid; i < N * 4 * vecs; i += blockDim.x) {
      const int row = i / (4 * vecs);
      const int rem = i - row * 4 * vecs;
      const int part = rem / vecs;
      const int c = rem - part * vecs;
      const uint4 u = *reinterpret_cast<const uint4*>(
          part < 3 ? base + (size_t)row * 3 * C + part * C + c * 8
                   : dbase + (size_t)row * C + c * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
      const int o = row * ld + c * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float f = __bfloat162float(e[j]);
        if (part == 0) {
          qs[o + j] = round_bf16(f * scale_c);
          qf[o + j] = f * scale;
        } else {
          (part == 1 ? k : (part == 2 ? v : dO))[o + j] = f;
        }
      }
    }
    __syncthreads();

    // ---- scores (fp32 dot + bias + mask) and dP = dO v^T -----------------
    const float* mw =
        !mask ? nullptr
              : (kDense ? ms + (size_t)(((w - w0) % kCell) % tiles) * NN
                        : mask + (size_t)(w % mask_windows) * NN);
    for (int i = tid; i < NN; i += blockDim.x) {
      const int r = i / N;
      const int c = i - r * N;
      const float* qr = qs + r * ld;
      const float* kc = k + c * ld;
      const float* gr = dO + r * ld;
      const float* vc = v + c * ld;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < hd; ++d) {
        s = fmaf(qr[d], kc[d], s);
        dp = fmaf(gr[d], vc[d], dp);
      }
      s += bh[i];
      if (mw) s += mw[i];
      p[r * lds + c] = s;
      ds[r * lds + c] = dp;
    }
    __syncthreads();

    // ---- fp32 softmax and dS, one warp per row ----------------------------
    for (int r = warp; r < N; r += nwarps) {
      float* pr = p + r * lds;
      float* dr = ds + r * lds;
      float m = -INFINITY;
      for (int c = lane; c < N; c += 32) m = fmaxf(m, pr[c]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lane; c < N; c += 32) {
        const float e = expf(pr[c] - m);
        pr[c] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float rs = 0.f;
      for (int c = lane; c < N; c += 32) {
        const float pv = pr[c] / sum;
        pr[c] = pv;
        rs = fmaf(dr[c], pv, rs);
      }
      rs = warp_sum(rs);
      for (int c = lane; c < N; c += 32) {
        const float dsv = pr[c] * (dr[c] - rs);
        dr[c] = dsv;
        acc[r * N + c] += dsv;
      }
    }
    __syncthreads();

    // ---- dq = dS k * scale, dk = dS^T (q*scale), dv = P^T dO -------------
    __nv_bfloat16* ob = dqkv + (size_t)w * N * 3 * C + h * hd;
    for (int i = tid; i < N * hd; i += blockDim.x) {
      const int r = i / hd;
      const int d = i - r * hd;
      float dq = 0.f, dk = 0.f, dv = 0.f;
      for (int j = 0; j < N; ++j) {
        dq = fmaf(ds[r * lds + j], k[j * ld + d], dq);
        dk = fmaf(ds[j * lds + r], qf[j * ld + d], dk);
        dv = fmaf(p[j * lds + r], dO[j * ld + d], dv);
      }
      __nv_bfloat16* o = ob + (size_t)r * 3 * C + d;
      o[0] = __float2bfloat16(dq * scale);
      o[C] = __float2bfloat16(dk);
      o[2 * C] = __float2bfloat16(dv);
    }
  }
  __syncthreads();
  float* out = dbias_part + ((size_t)grp * nH + h) * NN;
  for (int i = tid; i < NN; i += blockDim.x) out[i] = acc[i];
}

// dbias[i] = sum over groups of the partials, in group order.
__global__ void sum_groups_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, int n_groups,
                                  int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.f;
  for (int g = 0; g < n_groups; ++g) s += part[(size_t)g * len + i];
  out[i] = s;
}

template <bool kDense>
int launch_bwd(const void* qkv, const void* bias, const void* mask,
               const void* dout, void* dqkv, void* dbias_part, void* dbias,
               int n_windows, int N, int C, int num_heads, int mask_windows,
               int group, float scale_c, float scale, cudaStream_t st) {
  if (group < 1 || N < 1 || num_heads < 1 || C % num_heads ||
      (C / num_heads) % 8)
    return (int)cudaErrorInvalidValue;
  const int hd = C / num_heads;
  const int n_groups = (n_windows + group - 1) / group;
  const int tiles =
      (kDense && mask) ? (mask_windows < kCell ? mask_windows : kCell) : 0;
  const size_t smem = sizeof(float) * (5 * (size_t)N * (hd + 1) +
                                       2 * (size_t)N * (N + 1) +
                                       (2 + (size_t)tiles) * N * N);
  cudaError_t e = cudaFuncSetAttribute(
      window_attn_bwd_kernel<kDense>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_groups, num_heads);
  window_attn_bwd_kernel<kDense><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(dbias_part),
      n_windows, group, N, C, hd, mask_windows > 0 ? mask_windows : 1,
      scale_c, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int len = num_heads * N * N;
  sum_groups_kernel<<<(len + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(dbias_part), static_cast<float*>(dbias),
      n_groups, len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mtlora_window_attn_bwd(const void* qkv, const void* bias,
                                      const void* mask, const void* dout,
                                      void* dqkv, void* dbias_part,
                                      void* dbias, int n_windows, int N,
                                      int C, int num_heads, int mask_windows,
                                      int group, float scale_c, float scale,
                                      void* stream) {
  return launch_bwd<false>(qkv, bias, mask, dout, dqkv, dbias_part, dbias,
                           n_windows, N, C, num_heads, mask_windows, group,
                           scale_c, scale, (cudaStream_t)stream);
}

// Kernel 1c's backward: groups of `cells` whole cells; n_windows a
// multiple of kCell, and the mask period tiling the cells, as in the
// forward.
extern "C" int mtlora_window_attn_dense_bwd(
    const void* qkv, const void* bias, const void* mask, const void* dout,
    void* dqkv, void* dbias_part, void* dbias, int n_windows, int N, int C,
    int num_heads, int mask_windows, int cells, float scale_c, float scale,
    void* stream) {
  if (n_windows % kCell || cells < 1 ||
      (mask && (mask_windows < 1 ||
                (mask_windows % kCell && kCell % mask_windows))))
    return (int)cudaErrorInvalidValue;
  return launch_bwd<true>(qkv, bias, mask, dout, dqkv, dbias_part, dbias,
                          n_windows, N, C, num_heads, mask_windows,
                          cells * kCell, scale_c, scale,
                          (cudaStream_t)stream);
}
