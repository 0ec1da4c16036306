// Window attention core (backward) for Hopper, on tensor cores.
//
// Replaces mtlora_tpu/ops/pallas_window_attn.py: _bwd_kernel (:119),
// launched by _run_bwd (:327) through the custom VJP of _fused_windows, and
// in its dense mode (chunks = 4) by _run_bwd_dense (:435). Per window w and
// head h, P is recomputed as the forward computes it (q*scale rounded to
// bf16 with the bf16 scale, fp32 scores + bias + mask, fp32 softmax), and
//   dv = P^T dO,  dP = dO v^T,  dS = P * (dP - rowsum(dP * P)),
//   dq = (dS k) * scale,  dk = (dS^T q) * scale,
//   dbias[h] = sum over every window of dS (fp32).
//
// Numerics: the TPU kernel issues every product with precision _prec(dtype)
// (:53), None for bf16 input, which is Mosaic's single bf16 pass: the fp32
// operands P, dS and q*scale are rounded to bf16 for each product and the
// sums run in fp32. mma.sync m16n8k16 with bf16 operands and fp32
// accumulation computes that function. S = bf16(q*scale_c) k^T and
// dP = dO v^T take bf16 operands as they are; P and dS are rounded to bf16
// for dv, dq and dk. For dk the port takes q as stored (exact in bf16) and
// applies the fp32 scale after the product, where the TPU rounded q*scale
// to bf16: one rounding fewer, nearer the fp32 plain version. dbias is the
// fp32 sum of the fp32 dS.
//
// What bounds it: per (window, head) pair 12.5 KB of bf16 in (q, k, v, dO)
// and 9.4 KB out (dq, dk, dv), against five 49 x 49 x 32 products (five
// 64 x 64 x 32 on the tensor cores, 1.3 MFLOP): about 60 FLOP a byte, far
// below the card's ridge of ~295, so the kernel is bound by bytes. As on
// the TPU, the [windows, heads, N, N] P and dS never reach device memory.
//
// Design: one block of 4 warps per (group of windows, head); the head dim is
// 32 and N <= 64 is padded to 64 rows. Each window's q, k, v and dO tiles
// (64 x 32 bf16, rows >= N zero, 16-byte chunks XOR-swizzled so that
// ldmatrix reads are free of bank conflicts) arrive by cp.async into one of
// two buffers while the block computes the window before. The head's bias
// is staged once per block (fp32, rows padded to kBiasLd); the mask tile
// of the window (kernel 1c: the tiles of its 8-window cell) is copied by
// cp.async in 16-byte chunks of the mask array as it lies, after the
// window before has finished its softmax. Warp i owns query rows
// 16i..16i+15: S and dP as 16 x 64 fp32 register tiles (ldmatrix
// fragments, mma.sync), bias and mask added, columns >= N at -inf, the row
// max, sums and rowsum(dP * P) by quad shuffles; dS = P (dP - rowsum) is
// summed into the thread's dbias registers, and dq = dS k comes from dS's
// fragments repacked as bf16 A operands, k by ldmatrix.trans. P and dS go
// to shared memory once as bf16; then warp i computes dk and dv for key
// rows 16i..16i+15 from dS^T q and P^T dO (both operands by
// ldmatrix.trans). dq, dk and dv are staged by rows in shared memory and
// leave as 16-byte stores of dqkv rows. Each block writes its dbias
// partial once; a second kernel sums the groups' partials in group order:
// deterministic, with no fp32 atomics. The launch plan (windows per block,
// blocks, shared-memory bytes) is ops/window_attn.py:bwd_plan; the kernel
// traps if the bytes do not hold its layout.
//
// Kernel 1c's backward (kDense) is the same body with groups of whole
// 8-window cells: a cell's mask tiles (min(8, nW) of them) are staged once
// at its first window, and the dbias partials, one per cell group, are
// summed in group order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_tiles.cuh"

namespace {

using namespace wtile;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// blocks an SM: the plan's assumption, and the register cap it sets
constexpr int kBlocksPerSm = 3;
constexpr int kBiasLd = 72;     // fp32 row stride of the staged bias
constexpr int kOutLd = 104;     // bf16 row stride of the staged output
constexpr int kBufBytes = 4 * kTile * 2;      // one window's four tiles
constexpr int kPsBytes = 2 * kRows * kRows * 2;  // P and dS, bf16

static_assert(kWarps * 16 * kOutLd * 2 <= kPsBytes,
              "the staged output rows alias P and dS");

// The shared-memory layout's bytes: two windows' tiles, P and dS, the
// bias, the mask tiles.
__host__ __device__ constexpr size_t smem_bytes(int N, int tiles) {
  return 2 * (size_t)kBufBytes + kPsBytes + (size_t)N * kBiasLd * 4 +
         (size_t)tiles * mask_chunks(N) * 16;
}

template <bool kDense>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
window_attn_bwd_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const float* __restrict__ bias,
                       const float* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dqkv,
                       float* __restrict__ dbias_part, int n_windows,
                       int group, int N, int C, int mask_windows, int tiles,
                       float scale_c, float scale) {
  if (smem_bytes(N, tiles) > dynamic_smem_bytes()) __trap();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(smem + 2 * kBufBytes);
  float* bs = reinterpret_cast<float*>(smem + 2 * kBufBytes + kPsBytes);
  float* ms = bs + N * kBiasLd;
  const int mslot = 4 * mask_chunks(N);   // floats per mask tile

  const int grp = blockIdx.x, h = blockIdx.y, nH = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NN = N * N, C3 = 3 * C;
  const int w0 = grp * group;
  const int w1 = min(w0 + group, n_windows);
  const float* mend = mask ? mask + (size_t)mask_windows * NN : nullptr;

  // the first window's tiles and mask tiles in flight while the bias is
  // staged and the pad rows of both buffers are zeroed
  load_window<4, kThreads>(bufs, qkv, dout, w0, h, N, C);
  for (int j = 0; j < tiles; ++j)
    load_mask<kThreads>(ms + j * mslot, mask, (w0 + j) % mask_windows, NN,
                        mend);
  cp_async_commit();
  for (int i = tid; i < NN; i += kThreads) {
    const int r = i / N;
    bs[r * kBiasLd + i - r * N] = bias[(size_t)h * NN + i];
  }
  for (int i = tid; i < 8 * (kRows - N) * 4; i += kThreads) {
    const int tile = i / ((kRows - N) * 4), rem = i - tile * (kRows - N) * 4;
    const int r = N + (rem >> 2);
    *reinterpret_cast<uint4*>(bufs + tile * kTile + sw32(r, rem & 3)) =
        make_uint4(0, 0, 0, 0);
  }

  float dbacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbacc[j][e] = 0.f;
  const int r0 = warp * 16;

  for (int w = w0; w < w1; ++w) {
    const int i = w - w0;
    const __nv_bfloat16* qs = bufs + (i & 1) * 4 * kTile;
    const __nv_bfloat16* ks = qs + kTile;
    const __nv_bfloat16* vs = ks + kTile;
    const __nv_bfloat16* os = vs + kTile;
    // the next window's tiles go to the other buffer, whose last reader
    // (the window before) has passed the barrier ahead of its output
    if (w + 1 < w1)
      load_window<4, kThreads>(bufs + ((i + 1) & 1) * 4 * kTile, qkv, dout,
                               w + 1, h, N, C);
    cp_async_commit();
    cp_async_wait<1>();   // this window's tiles and mask tiles
    __syncthreads();

    // ---- S = bf16(q scale_c) k^T and dP = dO v^T: rows r0..r0+15 --------
    uint32_t qa[2][4], oa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int ch = 2 * kk + (lane >> 4);
      ldsm_x4(qa[kk], qs + sw32(row, ch));
      ldsm_x4(oa[kk], os + sw32(row, ch));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][e]);
        qa[kk][e] = pack_bf16(__low2float(v) * scale_c,
                              __high2float(v) * scale_c);
      }
    }
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int key = 16 * p + (lane & 7) + (lane >> 4) * 8;
        const int ch = 2 * kk + ((lane >> 3) & 1);
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, ks + sw32(key, ch));
        ldsm_x4(vb, vs + sw32(key, ch));
        mma_bf16_16816(s[2 * p], qa[kk], kb[0], kb[1]);
        mma_bf16_16816(s[2 * p + 1], qa[kk], kb[2], kb[3]);
        mma_bf16_16816(dp[2 * p], oa[kk], vb[0], vb[1]);
        mma_bf16_16816(dp[2 * p + 1], oa[kk], vb[2], vb[3]);
      }
    }

    // ---- bias, mask, softmax, dS (rows g and g + 8 of the warp's 16) ----
    const float* mw = nullptr;
    if (tiles) {
      const int mi = w % mask_windows;
      mw = ms + (kDense ? (i % kCell) % tiles : 0) * mslot +
           ((size_t)mi * NN & 3);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      const bool rok = row < N;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        float2 b = make_float2(0.f, 0.f);
        if (rok) b = *reinterpret_cast<const float2*>(bs + row * kBiasLd + c);
        float v0 = s[j][2 * half] + b.x, v1 = s[j][2 * half + 1] + b.y;
        if (mw && rok) {
          if (c < N) v0 += mw[row * N + c];
          if (c + 1 < N) v1 += mw[row * N + c + 1];
        }
        v0 = (rok && c < N) ? v0 : -INFINITY;
        v1 = (rok && c + 1 < N) ? v1 : -INFINITY;
        s[j][2 * half] = v0;
        s[j][2 * half + 1] = v1;
        mx = fmaxf(mx, fmaxf(v0, v1));
      }
      mx = quad_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = rok ? __expf(s[j][2 * half + e] - mx) : 0.f;
          s[j][2 * half + e] = p;
          sum += p;
        }
      sum = quad_sum(sum);
      const float inv = rok ? 1.f / sum : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = s[j][2 * half + e] * inv;
          s[j][2 * half + e] = p;
          rs = fmaf(dp[j][2 * half + e], p, rs);
        }
      rs = quad_sum(rs);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = s[j][2 * half + e] * (dp[j][2 * half + e] - rs);
          dp[j][2 * half + e] = d;
          dbacc[j][2 * half + e] += d;
        }
        const int off = sw64(row, j) + 2 * t;
        *reinterpret_cast<uint32_t*>(ps + off) =
            pack_bf16(s[j][2 * half], s[j][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(ps + kRows * kRows + off) =
            pack_bf16(dp[j][2 * half], dp[j][2 * half + 1]);
      }
    }

    // ---- dq = bf16(dS) k: dS's C fragments as A fragments ---------------
    float dq[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                             pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                             pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                             pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int n0 = 0; n0 < 4; n0 += 2) {
        const int key = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldsm_x4_t(b, ks + sw32(key, n0 + (lane >> 4)));
        mma_bf16_16816(dq[n0], a, b[0], b[1]);
        mma_bf16_16816(dq[n0 + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // P and dS whole; this window's mask reads done

    // the next window's mask tile (kernel 1c: the next cell's tiles)
    if (tiles && w + 1 < w1 && (!kDense || (i + 1) % kCell == 0)) {
      for (int j = 0; j < (kDense ? tiles : 1); ++j)
        load_mask<kThreads>(ms + j * mslot, mask, (w + 1 + j) % mask_windows,
                            NN, mend);
    }
    cp_async_commit();

    // ---- dk = bf16(dS)^T q, dv = bf16(P)^T dO: key rows r0..r0+15 -------
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int qrow = 16 * kk + (lane & 7) + (lane >> 4) * 8;
      const int kch = 2 * warp + ((lane >> 3) & 1);
      uint32_t da[4], pa[4];
      ldsm_x4_t(da, ps + kRows * kRows + sw64(qrow, kch));
      ldsm_x4_t(pa, ps + sw64(qrow, kch));
#pragma unroll
      for (int n0 = 0; n0 < 4; n0 += 2) {
        const int row = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int ch = n0 + (lane >> 4);
        uint32_t qb[4], ob[4];
        ldsm_x4_t(qb, qs + sw32(row, ch));
        ldsm_x4_t(ob, os + sw32(row, ch));
        mma_bf16_16816(dk[n0], da, qb[0], qb[1]);
        mma_bf16_16816(dk[n0 + 1], da, qb[2], qb[3]);
        mma_bf16_16816(dv[n0], pa, ob[0], ob[1]);
        mma_bf16_16816(dv[n0 + 1], pa, ob[2], ob[3]);
      }
    }
    __syncthreads();   // every read of P and dS done: their space is free

    // ---- dq | dk | dv rows r0..r0+15, staged, as 16-byte stores --------
    __nv_bfloat16* st = ps + warp * 16 * kOutLd;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        __nv_bfloat16* o = st + (g + 8 * half) * kOutLd + 8 * n + 2 * t;
        const int e = 2 * half;
        *reinterpret_cast<uint32_t*>(o) =
            pack_bf16(dq[n][e] * scale, dq[n][e + 1] * scale);
        *reinterpret_cast<uint32_t*>(o + kHd) =
            pack_bf16(dk[n][e] * scale, dk[n][e + 1] * scale);
        *reinterpret_cast<uint32_t*>(o + 2 * kHd) =
            pack_bf16(dv[n][e], dv[n][e + 1]);
      }
    __syncwarp();
    __nv_bfloat16* ob = dqkv + (size_t)w * N * C3 + h * kHd;
    for (int k = lane; k < 16 * 12; k += 32) {
      const int r = k / 12, c = k - r * 12;
      if (r0 + r < N)
        *reinterpret_cast<uint4*>(ob + (size_t)(r0 + r) * C3 + (c >> 2) * C +
                                  (c & 3) * 8) =
            *reinterpret_cast<const uint4*>(st + r * kOutLd + c * 8);
    }
  }

  // ---- the block's dbias partial, each element from its one thread -----
  float* out = dbias_part + ((size_t)grp * nH + h) * NN;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        if (c < N) out[row * N + c] = dbacc[j][2 * half + e];
      }
  }
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

// group: windows per block (kDense: a multiple of kCell); smem: the plan's
// shared-memory bytes.
template <bool kDense>
int launch_bwd(const void* qkv, const void* bias, const void* mask,
               const void* dout, void* dqkv, void* dbias_part, void* dbias,
               int n_windows, int N, int C, int num_heads, int mask_windows,
               int group, int smem, float scale_c, float scale,
               cudaStream_t st) {
  if (n_windows < 1 || group < 1 || N < 1 || N > kRows || num_heads < 1 ||
      C != num_heads * kHd || (kDense && group % kCell) ||
      (mask && (mask_windows < 1 || n_windows % mask_windows ||
                (reinterpret_cast<uintptr_t>(mask) & 15))))
    return (int)cudaErrorInvalidValue;
  const int tiles =
      !mask ? 0 : (kDense ? (mask_windows < kCell ? mask_windows : kCell) : 1);
  const int n_groups = (n_windows + group - 1) / group;
  cudaError_t e = cudaFuncSetAttribute(
      window_attn_bwd_kernel<kDense>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_groups, num_heads);
  window_attn_bwd_kernel<kDense><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<const __nv_bfloat16*>(dout),
      static_cast<__nv_bfloat16*>(dqkv), static_cast<float*>(dbias_part),
      n_windows, group, N, C, mask ? mask_windows : 1, tiles, scale_c, scale);
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
                                      int group, int smem, float scale_c,
                                      float scale, void* stream) {
  return launch_bwd<false>(qkv, bias, mask, dout, dqkv, dbias_part, dbias,
                           n_windows, N, C, num_heads, mask_windows, group,
                           smem, scale_c, scale, (cudaStream_t)stream);
}

// Kernel 1c's backward: groups of whole cells; n_windows a multiple of
// kCell, and the mask period tiling the cells, as in the forward.
extern "C" int mtlora_window_attn_dense_bwd(
    const void* qkv, const void* bias, const void* mask, const void* dout,
    void* dqkv, void* dbias_part, void* dbias, int n_windows, int N, int C,
    int num_heads, int mask_windows, int group, int smem, float scale_c,
    float scale, void* stream) {
  if (n_windows % kCell ||
      (mask && (mask_windows < 1 ||
                (mask_windows % kCell && kCell % mask_windows))))
    return (int)cudaErrorInvalidValue;
  return launch_bwd<true>(qkv, bias, mask, dout, dqkv, dbias_part, dbias,
                          n_windows, N, C, num_heads, mask_windows, group,
                          smem, scale_c, scale, (cudaStream_t)stream);
}
