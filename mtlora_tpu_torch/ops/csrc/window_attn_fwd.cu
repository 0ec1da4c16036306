// Window attention core (forward) for Hopper, on tensor cores: kernel 1
// and kernel 1c, one body.
//
// Replaces mtlora_tpu/ops/pallas_window_attn.py: _fwd_kernel (:84),
// launched by _run_fwd (:302, call :312) through
// fused_window_attention_windowed (:607) (kernel 1), and in its dense mode
// (chunks = 4) by _run_fwd_dense (:410, call :420) through
// _fused_windows_dense (:476) (kernel 1c). Per window w and head h:
//   out[w, :, h] = bf16(bf16(softmax(bf16(q scale_c) k^T + bias[h]
//                                    + mask[w % nW])) v)
// with scale_c the scale rounded to bf16, fp32 scores, bias, mask and
// softmax, P rounded to bf16, and both products on bf16 operands with
// fp32 sums: Mosaic's single bf16 pass (_prec(None), :53), which
// mma.sync m16n8k16 computes.
//
// What bounds it: per (window, head) pair 9.4 KB of bf16 q, k, v in and
// 3.1 KB out at N = 49, against two 49 x 49 x 32 products (two 64 x 64 x
// 32 on the tensor cores): about 25 FLOP a byte, far below the card's
// ridge of ~295, so the kernel is bound by bytes; as on the TPU, the
// [windows, heads, N, N] scores never reach device memory.
//
// Design: one block of 4 warps per (group of consecutive windows, head),
// one wave of the card (ops/window_attn.py:fwd_plan). Each window's q, k
// and v tiles (64 x 32 bf16, rows >= N zero, 16-byte chunks XOR-swizzled,
// window_tiles.cuh) arrive by cp.async into one of kStages buffers, the
// next window in flight while the block computes this one; one block
// barrier a window. The head's bias lives in registers for the whole
// block: each thread holds the 32 scores of its mma fragments, and their
// bias, with -inf at the columns >= N, so that the padded keys drop out
// of the softmax without a select. Warp i owns query rows 16i..16i+15:
//   S = bf16(q scale_c) k^T by mma.sync on ldmatrix fragments, a 16 x 64
//   fp32 register tile; + bias, + mask (read from the window's mask tile
//   in shared memory); row max and sum by quad shuffles, exp2 of the
//   log2(e)-prescaled scores (ex2.approx); P = bf16(e / sum);
//   P's C fragments repacked in registers as the A fragments of P v, v
//   by ldmatrix.trans: P never reaches shared memory;
//   the 16 x 32 fp32 output to bf16, staged over the warp's own q rows
//   (which no other warp reads), and written as 16-byte stores of each
//   row's 64-byte head slice.
// No atomics: two launches are bit-identical.
//
// The mask: kernel 1 copies the window's tile (w % nW) with its q, k, v,
// in 16-byte chunks of the mask array as it lies (window_tiles.cuh,
// load_mask), one slot a buffer. Kernel 1c (kDense) stages its cells'
// tiles at once where nW divides the 8-window cell (min(8, nW) = nW
// tiles, kept for the whole block); where nW is a multiple of 8, a cell's
// 8 tiles are its 8 windows' own, and they come one a window as kernel
// 1's do (the same bytes, overlapped with the window before). The
// forward keeps no per-cell partial, so the plan cuts kernel 1c's
// windows into groups without regard to cells: path B's 32 windows of 24
// heads fill the card's 132 SMs.
//
// Every read of the padded rows and columns stays finite: the mask slot
// holds 64 zeroed floats past its tile (the reads of columns >= N), the
// rows >= N read row 0's mask, and the tiles' rows >= N are zero.

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
constexpr int kBlocksPerSm = 4;
// buffers of a window's q, k, v tiles (and its mask slot): one computed
// while the next loads (three were slower on the H100)
constexpr int kStages = 2;
constexpr int kQkvBytes = 3 * kTile * 2;   // one window's three tiles
constexpr float kLog2e = 1.4426950408889634f;

// Floats of a mask slot: the tile's 16-byte chunks and 64 floats more,
// the reach of the padded columns' reads past the tile.
__host__ __device__ constexpr int mask_slot_floats(int N) {
  return 4 * mask_chunks(N) + 64;
}

// The shared-memory layout's bytes: the buffers' tiles, then a mask slot
// a buffer (per_window) and the resident mask tiles (kernel 1c).
__host__ __device__ constexpr size_t smem_bytes(int N, bool per_window,
                                                int tiles) {
  return (size_t)kStages * kQkvBytes +
         (size_t)((per_window ? kStages : 0) + tiles) * mask_slot_floats(N) *
             4;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Windows [grp * group, min(grp * group + group, n_windows)) of head
// blockIdx.y. tiles: the resident mask tiles (kDense, nW dividing the
// cell), else 0; with a mask and no resident tiles, a slot a buffer.
template <bool kDense>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
window_attn_fwd_rows(const __nv_bfloat16* __restrict__ qkv,
                     const float* __restrict__ bias,
                     const float* __restrict__ mask,
                     __nv_bfloat16* __restrict__ out, int n_windows,
                     int group, int N, int C, int mask_windows, int tiles,
                     float scale_c) {
  const bool per_window = mask && !(kDense && tiles);
  if (smem_bytes(N, per_window, kDense ? tiles : 0) > dynamic_smem_bytes())
    __trap();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* bufs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ms = reinterpret_cast<float*>(smem + kStages * kQkvBytes);
  const int mslot = mask_slot_floats(N);

  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int NN = N * N;
  const int w0 = blockIdx.x * group;
  const int w1 = min(w0 + group, n_windows);
  const float* mend = mask ? mask + (size_t)mask_windows * NN : nullptr;
  const int r0 = warp * 16;

  // zero the pad rows of every buffer and the mask slots (the tail past
  // each copy stays finite), then order them before the first copies
  for (int i = tid; i < kStages * 3 * (kRows - N) * 4; i += kThreads) {
    const int tile = i / ((kRows - N) * 4), rem = i - tile * (kRows - N) * 4;
    *reinterpret_cast<uint4*>(bufs + tile * kTile +
                              sw32(N + (rem >> 2), rem & 3)) =
        make_uint4(0, 0, 0, 0);
  }
  const int n_slots = per_window ? kStages : (kDense ? tiles : 0);
  for (int i = tid; i < n_slots * mslot / 4; i += kThreads)
    reinterpret_cast<float4*>(ms)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // the first kStages - 1 windows in flight (kernel 1c's resident tiles
  // with the first), each its own group of copies
  if (kDense && tiles)
    for (int j = 0; j < tiles; ++j)
      load_mask<kThreads>(ms + j * mslot, mask, j, NN, mend);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (w0 + s < w1) {
      load_window<3, kThreads>(bufs + s * 3 * kTile, qkv, nullptr, w0 + s, h,
                               N, C);
      if (per_window)
        load_mask<kThreads>(ms + s * mslot, mask, (w0 + s) % mask_windows,
                            NN, mend);
    }
    cp_async_commit();
  }

  // the head's bias at the thread's fragment positions (rows r0 + g and
  // r0 + g + 8, columns 8j + 2t + e): 0 on the rows >= N, -inf on the
  // columns >= N; and the mask rows those positions read
  float bj[8][4];
  int mrow[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    const bool rok = row < N;
    mrow[half] = rok ? row * N : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        bj[j][2 * half + e] =
            c >= N ? -INFINITY
                   : (rok ? bias[(size_t)h * NN + row * N + c] : 0.f);
      }
  }

  for (int w = w0; w < w1; ++w) {
    const int i = w - w0;
    const int stage = i % kStages;
    cp_async_wait<kStages - 2>();   // this window's copies (and tiles)
    __syncthreads();                // ... everyone's; the window before done
    {
      // the window kStages - 1 ahead, into the buffer the window before
      // has left
      const int wn = w + kStages - 1;
      const int sn = (i + kStages - 1) % kStages;
      if (wn < w1) {
        load_window<3, kThreads>(bufs + sn * 3 * kTile, qkv, nullptr, wn, h,
                                 N, C);
        if (per_window)
          load_mask<kThreads>(ms + sn * mslot, mask, wn % mask_windows, NN,
                              mend);
      }
      cp_async_commit();
    }
    __nv_bfloat16* qs = bufs + stage * 3 * kTile;
    const __nv_bfloat16* ks = qs + kTile;
    const __nv_bfloat16* vs = ks + kTile;

    // ---- S = bf16(q scale_c) k^T: rows r0..r0+15, 64 keys --------------
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldsm_x4(qa[kk], qs + sw32(row, 2 * kk + (lane >> 4)));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 v =
            *reinterpret_cast<const __nv_bfloat162*>(&qa[kk][e]);
        qa[kk][e] = pack_bf16(__low2float(v) * scale_c,
                              __high2float(v) * scale_c);
      }
    }
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int key = 16 * p + (lane & 7) + (lane >> 4) * 8;
        uint32_t kb[4];
        ldsm_x4(kb, ks + sw32(key, 2 * kk + ((lane >> 3) & 1)));
        mma_bf16_16816(s[2 * p], qa[kk], kb[0], kb[1]);
        mma_bf16_16816(s[2 * p + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // ---- + bias, + mask; softmax; P = bf16(e / sum) as A fragments -----
    const float* mw = nullptr;
    if (mask) {
      const int mi = w % mask_windows;
      mw = ms + (per_window ? stage : mi) * mslot + ((size_t)mi * NN & 3);
    }
    float inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = s[j][2 * half + e] + bj[j][2 * half + e];
          if (mw) v += mw[mrow[half] + 8 * j + 2 * t + e];
          s[j][2 * half + e] = v;
          mx = fmaxf(mx, v);
        }
      const float mo = quad_max(mx) * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(fmaf(s[j][2 * half + e], kLog2e, -mo));
          s[j][2 * half + e] = p;
          sum += p;
        }
      inv[half] = 1.f / quad_sum(sum);
    }
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0] * inv[0], s[2 * kk][1] * inv[0]);
      pa[kk][1] = pack_bf16(s[2 * kk][2] * inv[1], s[2 * kk][3] * inv[1]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0] * inv[0],
                            s[2 * kk + 1][1] * inv[0]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2] * inv[1],
                            s[2 * kk + 1][3] * inv[1]);
    }

    // ---- O = P v: v by ldmatrix.trans ------------------------------------
    float o[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n0 = 0; n0 < 4; n0 += 2) {
        const int key = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldsm_x4_t(b, vs + sw32(key, n0 + (lane >> 4)));
        mma_bf16_16816(o[n0], pa[kk], b[0], b[1]);
        mma_bf16_16816(o[n0 + 1], pa[kk], b[2], b[3]);
      }
    }

    // ---- out rows r0..r0+15: staged over the warp's q rows, 16-byte
    // stores of each row's head slice -------------------------------------
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(qs + sw32(r0 + g + 8 * half, n) +
                                     2 * t) =
            pack_bf16(o[n][2 * half], o[n][2 * half + 1]);
    __syncwarp();
    __nv_bfloat16* ob = out + (size_t)w * N * C + h * kHd;
#pragma unroll
    for (int k = lane; k < 64; k += 32) {
      const int row = r0 + (k >> 2), c = k & 3;
      if (row < N)
        *reinterpret_cast<uint4*>(ob + (size_t)row * C + c * 8) =
            *reinterpret_cast<const uint4*>(qs + sw32(row, c));
    }
  }
}

// group and smem: the plan's windows per block and shared-memory bytes;
// tiles: kernel 1c's resident mask tiles (nW where it divides the cell),
// else 0.
template <bool kDense>
int launch_fwd(const void* qkv, const void* bias, const void* mask,
               void* out, int n_windows, int N, int C, int num_heads,
               int mask_windows, int group, int tiles, int smem,
               float scale_c, cudaStream_t st) {
  if (n_windows < 1 || group < 1 || N < 1 || N > kRows || num_heads < 1 ||
      C != num_heads * kHd || tiles < 0 || tiles > kCell ||
      (!kDense && tiles) || (tiles && (!mask || tiles != mask_windows)) ||
      (mask && (mask_windows < 1 || n_windows % mask_windows ||
                (reinterpret_cast<uintptr_t>(mask) & 15))))
    return (int)cudaErrorInvalidValue;
  const int n_groups = (n_windows + group - 1) / group;
  cudaError_t e = cudaFuncSetAttribute(
      window_attn_fwd_rows<kDense>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_groups, num_heads);
  window_attn_fwd_rows<kDense><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(out),
      n_windows, group, N, C, mask ? mask_windows : 1, tiles, scale_c);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 1 at qkv [n_windows, N, 3C] (bf16, head dim 32), bias
// [nH, N, N] and mask [mask_windows, N, N] (fp32, or null; 16-byte
// aligned), out [n_windows, N, C]; group and smem from the plan.
extern "C" int mtlora_window_attn_fwd_rows(const void* qkv, const void* bias,
                                           const void* mask, void* out,
                                           int n_windows, int N, int C,
                                           int num_heads, int mask_windows,
                                           int group, int smem,
                                           float scale_c, void* stream) {
  return launch_fwd<false>(qkv, bias, mask, out, n_windows, N, C, num_heads,
                           mask_windows, group, 0, smem, scale_c,
                           (cudaStream_t)stream);
}

// Kernel 1c: kernel 1's operands in whole 8-window cells, the mask period
// tiling them (nW a multiple of kCell or a divisor of it); tiles: the
// plan's resident mask tiles.
extern "C" int mtlora_window_attn_dense_fwd_rows(
    const void* qkv, const void* bias, const void* mask, void* out,
    int n_windows, int N, int C, int num_heads, int mask_windows, int group,
    int tiles, int smem, float scale_c, void* stream) {
  if (n_windows % kCell ||
      (mask && (mask_windows < 1 ||
                (mask_windows % kCell && kCell % mask_windows))))
    return (int)cudaErrorInvalidValue;
  return launch_fwd<true>(qkv, bias, mask, out, n_windows, N, C, num_heads,
                          mask_windows, group, tiles, smem, scale_c,
                          (cudaStream_t)stream);
}
