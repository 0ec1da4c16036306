// LoRA GEMM (kernel 8) for Hopper:
//   y = bf16( x W^T + s * bf16(x_drop A^T) B^T )
// with both products accumulated in fp32 and u = x_drop A^T rounded to
// bf16 before its product with B, as the TPU kernel rounds it; the layer's
// bias is added to the bf16 output outside, in bf16.
//
// Replaces mtlora_tpu/ops/pallas_lora_matmul.py: _kernel (two inputs, the
// adapter's input dropped) and _kernel_same (one input, read once),
// launched by lora_matmul_2d from lora_matmul and from its backward _bwd,
// which reuses the one-input kernel with swapped operands for
//   dx = dy W + s * bf16(dy B) A.
// Both layouts are template instances here: kT = false reads the module
// layouts W [N, K], A [r, K], B [N, r] for the forward; kT = true reads
// the same tensors transposed for dx (W as [N, K] with N the depth, B as
// the left and A as the right rank factor), staging them into shared
// memory in the layout the tensor cores take, so no transpose is ever
// written to device memory.
//
// What bounds it: at the Swin-T sites the depth K is 96 to 3072 and the
// rank 64, so each output element costs 2 (K + 64 + 64 K / N) operations
// against 4 to 6 bytes of x, x_drop and y: 16 to 600 FLOP per byte, below
// or near the card's ~295 FLOP/byte ridge; the small-K stages are bound by
// the bytes of the activations. What the TPU kernel kept out of device
// memory, the [M, N] adapter update, this one keeps out too.
// Design: one block of 4 warps per (64 rows, 128 output columns); the
// block walks K in chunks of 32, staging the x (and x_drop) rows, the W
// rows of its columns and the whole A chunk (r <= 64) in shared memory,
// two chunks deep: the next chunk streams in by cp.async (the dx layout's
// transposed weights through registers) while the warps multiply this one;
// each warp owns 16 rows and keeps its [16, 128] output and its [16, r] u
// in registers, fed by mma.sync m16n8k16 (bf16 in, fp32 accumulate). After
// the last chunk u goes to shared memory in bf16, the B tile of the
// block's columns is staged, and each warp adds s * bf16(u) B^T to its
// accumulators before storing bf16 pairs. u is recomputed by every column
// tile of a row tile (at most 24 at N = 3072): 64 / 128 of the main
// product's work per tile, kept for the simplicity of one pass. No TMA or
// wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBM = 64;          // rows per block, 16 per warp
constexpr int kBN = 128;         // output columns per block
constexpr int kBK = 32;          // depth of a staged chunk
constexpr int kRMax = 64;        // largest rank
constexpr int kWarps = 4;
constexpr int kLd = kBK + 8;     // row stride of the chunk tiles (bf16)
constexpr int kLdR = kRMax + 8;  // row stride of the rank tiles (bf16)

// dst[i][j] = src[(r0 + i) * ld + c0 + j] for i < ROWS, j < COLS (a
// multiple of 8), zero outside [0, rlim) x [0, clim); 16-byte copies,
// asynchronous: the caller commits and waits.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, int dld,
                                            const __nv_bfloat16* src, int ld,
                                            int r0, int c0, int rlim,
                                            int clim) {
  constexpr int kVc = COLS / 8;
  constexpr int kPer = ROWS * kVc / (kWarps * 32);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int i = threadIdx.x + p * kWarps * 32;
    const int r = i / kVc;
    const int c = (i - r * kVc) * 8;
    const bool in = r0 + r < rlim && c0 + c < clim;
    cp_async16(dst + r * dld + c,
               in ? src + (size_t)(r0 + r) * ld + c0 + c : src, in);
  }
}

// dst[i][j] = src[(c0 + j) * ld + r0 + i]: the transpose of a tile whose
// rows i run along src's contiguous dimension; all of a thread's 16-byte
// loads along i are issued before its 2-byte stores into shared memory.
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_t(__nv_bfloat16* dst, int dld,
                                        const __nv_bfloat16* src, int ld,
                                        int r0, int c0, int rlim, int clim) {
  constexpr int kVr = ROWS / 8;
  constexpr int kPer = kVr * COLS / (kWarps * 32);
  uint4 v[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int i = threadIdx.x + p * kWarps * 32;
    const int c = i / kVr;
    const int r = (i - c * kVr) * 8;
    v[p] = make_uint4(0, 0, 0, 0);
    if (r0 + r < rlim && c0 + c < clim)
      v[p] = *reinterpret_cast<const uint4*>(src + (size_t)(c0 + c) * ld +
                                             r0 + r);
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int i = threadIdx.x + p * kWarps * 32;
    const int c = i / kVr;
    const int r = (i - c * kVr) * 8;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[p]);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(r + j) * dld + c] = e[j];
  }
}

// Elements of one staged K chunk: x (and x_drop), the W rows of the
// block's columns, the A rows.
template <bool kTwo>
__host__ __device__ constexpr int chunk_elems() {
  return ((kTwo ? 2 : 1) * kBM + kBN + kRMax) * kLd;
}

// Stage the chunk at depth k0 into `buf`: the activations by cp.async,
// the weights by cp.async (forward) or transposed through registers (dx).
template <bool kT, bool kTwo>
__device__ __forceinline__ void load_chunk(
    __nv_bfloat16* buf, const __nv_bfloat16* X, const __nv_bfloat16* Xd,
    const __nv_bfloat16* W, const __nv_bfloat16* A, const __nv_bfloat16* B,
    int row0, int n0, int k0, int M, int K, int N, int r) {
  __nv_bfloat16* xs = buf;
  __nv_bfloat16* ws = buf + (kTwo ? 2 : 1) * kBM * kLd;
  __nv_bfloat16* as = ws + kBN * kLd;
  stage_async<kBM, kBK>(xs, kLd, X, K, row0, k0, M, K);
  if (kTwo)
    stage_async<kBM, kBK>(xs + kBM * kLd, kLd, Xd, K, row0, k0, M, K);
  if (kT) {
    stage_t<kBN, kBK>(ws, kLd, W, N, n0, k0, N, K);
    stage_t<kRMax, kBK>(as, kLd, B, r, 0, k0, r, K);
  } else {
    stage_async<kBN, kBK>(ws, kLd, W, K, n0, k0, N, K);
    stage_async<kRMax, kBK>(as, kLd, A, K, 0, k0, r, K);
  }
  cp_async_commit();
}

// The epilogue's rank tile, once per block: dst[i][j] = src[(r0 + i) *
// ld + j] for i < rows, j < cols (a multiple of 8), zero for r0 + i >=
// rlim; kT: dst[i][j] = src[j * ld + r0 + i], 16-byte loads along i.
template <bool kT>
__device__ __forceinline__ void stage_rank(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int ld,
                                           int r0, int rows, int cols,
                                           int rlim) {
  const int vr = kT ? rows / 8 : rows;
  const int vc = kT ? cols : cols / 8;
  for (int i = threadIdx.x; i < vr * vc; i += blockDim.x) {
    const int a = (kT ? i % vr * 8 : i / vc);      // first row of dst
    const int c = (kT ? i / vr : i % vc * 8);      // first column of dst
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + a < rlim)
      v = *reinterpret_cast<const uint4*>(
          kT ? src + (size_t)c * ld + r0 + a : src + (size_t)(r0 + a) * ld + c);
    if (kT) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(a + j) * kLdR + c] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + a * kLdR + c) = v;
    }
  }
}

// kT: operands read transposed (the dx mode); kTwo: a second, dropped
// input feeds the adapter. Shapes: X [M, K]; forward W [N, K], A [r, K],
// B [N, r]; dx mode W [K, N], A [r, N] (the rank factor on the right),
// B [K, r] (on the left), Y [M, N].
template <bool kT, bool kTwo>
__global__ void __launch_bounds__(kWarps * 32)
lora_matmul_kernel(const __nv_bfloat16* __restrict__ X,
                   const __nv_bfloat16* __restrict__ Xd,
                   const __nv_bfloat16* __restrict__ W,
                   const __nv_bfloat16* __restrict__ A,
                   const __nv_bfloat16* __restrict__ B,
                   __nv_bfloat16* __restrict__ Y, int M, int K, int N, int r,
                   float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // two chunk buffers: the next chunk streams in while this one is used
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  constexpr int kChunk = chunk_elems<kTwo>();
  // after the K loop: bf16(u) and the B tile, over the chunk buffers
  __nv_bfloat16* us = bufs;
  __nv_bfloat16* bs = us + kBM * kLdR;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  const int NT = min(kBN, N - n0) / 8;   // 8-column tiles of this block
  const int RT = r / 8;
  const int wr = warp * 16;

  float acc[kBN / 8][4];
  float u[kRMax / 8][4];
#pragma unroll
  for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < kRMax / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) u[i][e] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  load_chunk<kT, kTwo>(bufs, X, Xd, W, A, B, row0, n0, 0, M, K, N, r);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      // its buffer was last read in iteration kc - 1, before the barrier
      // that ended it
      load_chunk<kT, kTwo>(bufs + ((kc + 1) & 1) * kChunk, X, Xd, W, A, B,
                           row0, n0, (kc + 1) * kBK, M, K, N, r);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk kc is in shared memory for every thread
    const __nv_bfloat16* xs = bufs + (kc & 1) * kChunk;
    const __nv_bfloat16* xds = kTwo ? xs + kBM * kLd : xs;
    const __nv_bfloat16* ws = xs + (kTwo ? 2 : 1) * kBM * kLd;
    const __nv_bfloat16* as = ws + kBN * kLd;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4];
      load_a(a, xs + wr * kLd + kk, kLd, g, t);
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        if (nt < NT) {
          const __nv_bfloat16* bp = ws + (nt * 8 + g) * kLd + kk + 2 * t;
          mma_bf16_16816(acc[nt], a, ld32(bp), ld32(bp + 8));
        }
      }
      if (kTwo) load_a(a, xds + wr * kLd + kk, kLd, g, t);
#pragma unroll
      for (int jt = 0; jt < kRMax / 8; ++jt) {
        if (jt < RT) {
          const __nv_bfloat16* bp = as + (jt * 8 + g) * kLd + kk + 2 * t;
          mma_bf16_16816(u[jt], a, ld32(bp), ld32(bp + 8));
        }
      }
    }
    __syncthreads();  // chunk kc is consumed
  }
  // ---- bf16(u) of the warp's rows; the B tile of the block's columns ------
#pragma unroll
  for (int jt = 0; jt < kRMax / 8; ++jt) {
    if (jt < RT) {
      __nv_bfloat16* p = us + (wr + g) * kLdR + jt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(u[jt][0], u[jt][1]);
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * kLdR) =
          __floats2bfloat162_rn(u[jt][2], u[jt][3]);
    }
  }
  // forward: B [N, r] rows n0..; dx: A [r, N] read transposed
  stage_rank<kT>(bs, kT ? A : B, kT ? N : r, n0, kBN, r, N);
  __syncthreads();

  // ---- y = acc + s * (bf16(u) B^T), bf16 out -------------------------------
  uint32_t ua[kRMax / 16][4];
#pragma unroll
  for (int kt = 0; kt < kRMax / 16; ++kt)
    if (kt * 16 < r) load_a(ua[kt], us + wr * kLdR + kt * 16, kLdR, g, t);
  const int ra = row0 + wr + g;
  const int rb = ra + 8;
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    if (nt < NT) {
      float upd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < kRMax / 16; ++kt) {
        if (kt * 16 < r) {
          const __nv_bfloat16* bp = bs + (nt * 8 + g) * kLdR + kt * 16 + 2 * t;
          mma_bf16_16816(upd, ua[kt], ld32(bp), ld32(bp + 8));
        }
      }
      const int col = n0 + nt * 8 + 2 * t;
      // acc + upd * s with two roundings, as the plain version computes it
      if (ra < M)
        *reinterpret_cast<__nv_bfloat162*>(Y + (size_t)ra * N + col) =
            __floats2bfloat162_rn(
                __fadd_rn(acc[nt][0], __fmul_rn(upd[0], scale)),
                __fadd_rn(acc[nt][1], __fmul_rn(upd[1], scale)));
      if (rb < M)
        *reinterpret_cast<__nv_bfloat162*>(Y + (size_t)rb * N + col) =
            __floats2bfloat162_rn(
                __fadd_rn(acc[nt][2], __fmul_rn(upd[2], scale)),
                __fadd_rn(acc[nt][3], __fmul_rn(upd[3], scale)));
    }
  }
}

template <bool kT, bool kTwo>
int launch(const void* x, const void* xd, const void* w, const void* a,
           const void* b, void* y, int M, int K, int N, int r, float scale,
           cudaStream_t stream) {
  const size_t chunks = sizeof(__nv_bfloat16) * 2 * chunk_elems<kTwo>();
  const size_t ranks = sizeof(__nv_bfloat16) * (size_t)(kBM + kBN) * kLdR;
  const size_t smem = chunks > ranks ? chunks : ranks;
  cudaError_t e = cudaFuncSetAttribute(
      lora_matmul_kernel<kT, kTwo>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  lora_matmul_kernel<kT, kTwo><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(xd),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y),
      M, K, N, r, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int M, int K, int N, int r) {
  return M < 1 || K < 8 || N < 8 || K % 8 || N % 8 || r < 16 || r > kRMax ||
         r % 16 || (M + kBM - 1) / kBM > 65535;
}

}  // namespace

// y [M, N] = x [M, K] W^T + s bf16(x_drop A^T) B^T with W [N, K], A [r, K],
// B [N, r]; x_drop null: the one-input kernel (x_drop is x).
extern "C" int mtlora_lora_matmul_fwd(const void* x, const void* x_drop,
                                      const void* w, const void* a,
                                      const void* b, void* y, int M, int K,
                                      int N, int r, float scale,
                                      void* stream) {
  if (bad_shape(M, K, N, r)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_drop)
    return launch<false, true>(x, x_drop, w, a, b, y, M, K, N, r, scale, st);
  return launch<false, false>(x, x, w, a, b, y, M, K, N, r, scale, st);
}

// dx [M, K] = dy [M, N] W + s bf16(dy B) A with the forward's W [N, K],
// A [r, K], B [N, r].
extern "C" int mtlora_lora_matmul_dx(const void* dy, const void* w,
                                     const void* a, const void* b, void* dx,
                                     int M, int N, int K, int r, float scale,
                                     void* stream) {
  if (bad_shape(M, N, K, r)) return (int)cudaErrorInvalidValue;
  return launch<true, false>(dy, dy, w, a, b, dx, M, N, K, r, scale,
                             (cudaStream_t)stream);
}
