// Building blocks of the LN kernels (ln_lora*.cu, ln_mlp*.cu).
//
// Every row kernel gives a block of 4 warps 16 rows: the warps split the
// rows' LayerNorm statistics and the bf16 LN tile in shared memory, then
// split the output columns, multiplying with mma.sync m16n8k16 (bf16 in,
// fp32 accumulate). The A operand is a tile in shared memory, rows read
// straight from device memory, or accumulator registers; the B operand is
// a weight in the [n][k] layout (k contiguous) read from device memory
// through L1/L2 (the weights are at most 4.7 MB and shared by every
// block); ln_mlp.cu (by TMA) and ln_mlp_bwd.cu (by cp.async) stream their
// weights through shared memory instead. Reductions over rows (weight and LayerNorm-affine gradients)
// are written as fp32 partials and summed in a fixed order: no fp32
// atomics. The kernels defined here are static: every source that
// includes the header compiles its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dropout.cuh"
#include "mma.cuh"

namespace lnk {

typedef __nv_bfloat16 bf16;
constexpr float kEps = 1e-5f;
constexpr int kRows = 16;           // rows per warp
constexpr int kT = 64 + 8;          // row stride of a 64-wide bf16 tile

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// The activation of the GELU sites, a compile-time form, in fp32:
//   Erf   exact erf, z Phi(z);
//   Tanh  the tanh form of the JAX package's bf16 kernels (_gelu_fwd,
//         _gelu_pair with cheap = True, pallas_adapter_mlp.py:96-115):
//         0.5 z (1 + tanh(z (c + (c d) z^2))), c = sqrt(2/pi), d = 0.044715,
//         with tanhf (tanh.approx.f32's error of about 2^-11 would make it
//         another function);
//   Sig   the sigmoid form of tools/adapter_variants.py (_sig_gelu :42,
//         sig_pair :178), z sigma(1.5957691216 z + 0.0713548163 z^3),
//         with an exact divide where the TPU refines an approximate
//         reciprocal by one Newton step;
//   None  the identity.
// act_pair gives the activation and its derivative from one evaluation.
// The port's kernels take bf16 operands only, so their GELU is kGelu.
enum class Act { Erf, Tanh, Sig, None };
constexpr Act kGelu = Act::Tanh;

constexpr float kGeluC = 0.7978845608028654f;
constexpr float kGeluCD = 0.7978845608028654f * 0.044715f;
constexpr float kSigA = 1.5957691216f;
constexpr float kSigB = 0.0713548163f;

template <Act A>
__device__ __forceinline__ void act_pair(float z, float* gl, float* dg) {
  if constexpr (A == Act::Erf) {
    const float cdf = 0.5f * (1.f + erff(z * 0.70710678118654752f));
    *gl = z * cdf;
    *dg = cdf + z * (expf(-0.5f * z * z) * 0.39894228040143268f);
  } else if constexpr (A == Act::Tanh) {
    const float z2 = z * z;
    const float th = tanhf(z * (kGeluC + kGeluCD * z2));
    *gl = 0.5f * z * (1.f + th);
    *dg = 0.5f * (1.f + th) +
          0.5f * z * (1.f - th * th) * (kGeluC + 3.f * kGeluCD * z2);
  } else if constexpr (A == Act::Sig) {
    const float z2 = z * z;
    const float s = 1.f / (1.f + expf(-(z * (kSigA + kSigB * z2))));
    *gl = z * s;
    *dg = s + z * s * (1.f - s) * (kSigA + 3.f * kSigB * z2);
  } else {
    *gl = z;
    *dg = 1.f;
  }
}

template <Act A>
__device__ __forceinline__ float act_fwd(float z) {
  if constexpr (A == Act::Erf) {
    return z * (0.5f * (1.f + erff(z * 0.70710678118654752f)));
  } else if constexpr (A == Act::Tanh) {
    return 0.5f * z * (1.f + tanhf(z * (kGeluC + kGeluCD * (z * z))));
  } else if constexpr (A == Act::Sig) {
    return z * (1.f / (1.f + expf(-(z * (kSigA + kSigB * (z * z))))));
  } else {
    return z;
  }
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// LN output value: ((x - mu) * inv) * gamma + beta with the roundings of
// the plain version (no fused multiply-add), so that every kernel that
// recomputes it gets the same bits.
__device__ __forceinline__ float ln_val(float v, float mu, float inv,
                                        float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu), inv), g), b);
}

// Rows of a LayerNorm input: plain [M, K] (Wh == 0), or the 2x2 merge of a
// [.., H, W, Cin] stream (W = 2 Wh, K = 4 Cin), concat order
// k = (di + 2 dj) Cin + c (merge_ln_reference), output row
// m = (lead * H/2 + i) * Wh + j.
struct Rows {
  const bf16* x;
  int M, K, Cin, Wh;
  __device__ __forceinline__ size_t offset(int m, int k) const {
    if (Wh == 0) return (size_t)m * K + k;
    const int q = k / Cin, c = k - q * Cin;
    const int rr = m / Wh, j = m - rr * Wh;
    return ((size_t)(2 * rr + (q & 1)) * (2 * Wh) + 2 * j + (q >> 1)) * Cin +
           c;
  }
  __device__ __forceinline__ float2 pair(int m, int k) const {
    return bf2(x + offset(m, k));
  }
};

// Dropout of one stream as the host describes it: the call's int32 seeds
// in device memory, the stream, on or off, the threshold and 1/(1-rate).
struct DropSpec {
  const int* seed;
  int stream, on;
  uint32_t thr;
  float inv_keep;
};

// The same with the stream's key read and hashed once.
struct Drop {
  int on;
  uint32_t key, thr;
  float inv_keep;
  __device__ __forceinline__ float apply(float v, uint32_t row, uint32_t cols,
                                         uint32_t col) const {
    if (!on) return v;
    return drop_keep(key, row, cols, col, thr) ? v * inv_keep : 0.f;
  }
};

__device__ __forceinline__ Drop make_drop(const DropSpec& s) {
  Drop d;
  d.on = s.on;
  d.key = s.on ? drop_key(s.seed, s.stream) : 0u;
  d.thr = s.thr;
  d.inv_keep = s.inv_keep;
  return d;
}

__device__ __forceinline__ Drop no_drop() {
  Drop d;
  d.on = 0;
  d.key = d.thr = 0u;
  d.inv_keep = 1.f;
  return d;
}

// Mean and 1/sqrt(var + eps) of rows m0 + i, i = i0, i0 + di, .. < 16,
// into mu[i], inv[i] (var = E[x^2] - E[x]^2 in fp32, as _layer_norm
// computes it); rows past M get mu = 0, inv = 0. One warp per row; the
// warps of a block split the rows (i0 = warp, di = warps). Src is a row
// source with M, K and pair(m, k) (Rows, or the task merge's rows).
template <class Src>
__device__ __forceinline__ void rows_stats(const Src& R, int m0, float* mu,
                                           float* inv, int i0 = 0,
                                           int di = 1) {
  const int lane = lane_id();
  for (int i = i0; i < kRows; i += di) {
    const int m = m0 + i;
    float s = 0.f, q = 0.f;
    if (m < R.M)
      for (int k = 2 * lane; k < R.K; k += 64) {
        const float2 v = R.pair(m, k);
        s += v.x + v.y;
        q += v.x * v.x + v.y * v.y;
      }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) {
      const float mean = s / R.K;
      const bool in = m < R.M;
      mu[i] = in ? mean : 0.f;
      inv[i] = in ? rsqrtf(q / R.K - mean * mean + kEps) : 0.f;
    }
  }
  __syncwarp();
}

// tile[i][k] = bf16(drop(LN(x))[m0 + i][k]) (stream over [M, K]) for the
// rows i = i0, i0 + di, ..; rows past M are zero.
template <class Src>
__device__ __forceinline__ void rows_ln_tile(bf16* tile, int ld,
                                             const Src& R,
                                             const bf16* gamma,
                                             const bf16* beta, int m0,
                                             const float* mu,
                                             const float* inv,
                                             const Drop& d, int i0 = 0,
                                             int di = 1) {
  const int lane = lane_id();
  for (int i = i0; i < kRows; i += di) {
    const int m = m0 + i;
    for (int k = 2 * lane; k < R.K; k += 64) {
      float a = 0.f, b = 0.f;
      if (m < R.M) {
        const float2 v = R.pair(m, k), g = bf2(gamma + k), be = bf2(beta + k);
        a = d.apply(ln_val(v.x, mu[i], inv[i], g.x, be.x), m, R.K, k);
        b = d.apply(ln_val(v.y, mu[i], inv[i], g.y, be.y), m, R.K, k + 1);
      }
      st_bf2(tile + i * ld + k, a, b);
    }
  }
  __syncwarp();
}

template <int NT>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float s) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(s * f.x, s * f.y);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// acc[nt] += A[16 x 64] * B^T where A is the bf16 rounding of eight
// accumulator tiles c[0..8) of one warp (16 rows x 64 columns): two
// adjacent n8 accumulator tiles hold exactly the registers of one k16 A
// fragment, so A never goes through shared memory. B an [n][k] array in
// device memory (row stride ldb).
template <int NT>
__device__ __forceinline__ void mma_frag(float (*acc)[4], const float (*c)[4],
                                         const bf16* b, int ldb, int n0,
                                         int N) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t af[4];
    af[0] = pack_bf2(c[2 * ks][0], c[2 * ks][1]);
    af[1] = pack_bf2(c[2 * ks][2], c[2 * ks][3]);
    af[2] = pack_bf2(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    af[3] = pack_bf2(c[2 * ks + 1][2], c[2 * ks + 1][3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (n0 + nt * 8 < N) {
        const bf16* bp = b + (size_t)(n0 + nt * 8 + g) * ldb + ks * 16 + 2 * t;
        mma_bf16_16816(acc[nt], af, ld32(bp), ld32(bp + 8));
      }
    }
  }
}

// Fragment-order partial sums of one warp in shared memory ([8][32][4]
// floats from `p`, p = base + lane * 4).
__device__ __forceinline__ void load_frag(float (*acc)[4], const float* p) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float4 v = *reinterpret_cast<const float4*>(p + nt * 128);
    acc[nt][0] = v.x; acc[nt][1] = v.y; acc[nt][2] = v.z; acc[nt][3] = v.w;
  }
}

__device__ __forceinline__ void store_frag(float* p, const float (*acc)[4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    *reinterpret_cast<float4*>(p + nt * 128) =
        make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
}

// bf16 of the sum over the warps (in order) of fragment-order partials
// [warps][1024] into a [16][72] tile and, where out != null, to rows
// [m0, M) of a device array [M][64].
__device__ __forceinline__ void sum_frags(const float* part, int warps,
                                          bf16* tile, bf16* out, int m0,
                                          int M) {
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < warps; ++w) v += part[w * 1024 + i];
    const int nt = i >> 7, ln = (i >> 2) & 31, e = i & 3;
    const int row = (ln >> 2) + 8 * (e >> 1);
    const int col = nt * 8 + 2 * (ln & 3) + (e & 1);
    const bf16 b = __float2bfloat16(v);
    tile[row * kT + col] = b;
    if (out && m0 + row < M) out[(size_t)(m0 + row) * 64 + col] = b;
  }
}

// bf16 of an accumulator block into a tile at columns col0 + 8 nt.
template <int NT>
__device__ __forceinline__ void store_tile(bf16* tile, int ld,
                                           const float (*acc)[4], int col0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = col0 + nt * 8 + 2 * t;
    st_bf2(tile + g * ld + c, acc[nt][0], acc[nt][1]);
    st_bf2(tile + (g + 8) * ld + c, acc[nt][2], acc[nt][3]);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Weight gradients: part[stripe][n][k] = sum over the stripe's rows of
// P[row][n] Q[row][k]. One block of 4 warps per (64 n, 64 k, stripe); the
// 64-row tiles of both operands are copied as they lie ([row][n],
// [row][k]) by cp.async, two tiles deep, and read transposed by
// ldmatrix.trans (warp w: outputs n0 + 16w..).
// ---------------------------------------------------------------------------

// bf16 rows of a device array (row stride ld % 8 == 0, 16-byte aligned),
// optionally rounded s * v (du = bf16(s gy)).
struct MatSrc {
  const bf16* p;
  int ld;
  float s;
  int scaled;
};

static __global__ void __launch_bounds__(128)
wgrad_kernel(MatSrc P, MatSrc Q, int rows, int N, int Kq, int stripe_rows,
             float* __restrict__ part) {
  __shared__ __align__(16) bf16 pt[2][64 * kT];
  __shared__ __align__(16) bf16 qt[2][64 * kT];
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int w = threadIdx.x >> 5;
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int r_begin = blockIdx.z * stripe_rows;
  const int r_end = min(rows, r_begin + stripe_rows);
  // rows [rb, rb + 64) of both operands into buffer b, zero outside
  auto stage = [&](int b, int rb) {
    for (int i = threadIdx.x; i < 64 * 8; i += blockDim.x) {
      const int r = i >> 3, c = (i & 7) * 8, m = rb + r;
      const bool ip = m < r_end && n0 + c < N, iq = m < r_end && k0 + c < Kq;
      cp_async16(&pt[b][r * kT + c], ip ? P.p + (size_t)m * P.ld + n0 + c : P.p,
                 ip);
      cp_async16(&qt[b][r * kT + c], iq ? Q.p + (size_t)m * Q.ld + k0 + c : Q.p,
                 iq);
    }
    cp_async_commit();
  };
  float acc[8][4];
  zero<8>(acc);
  int b = 0;
  if (r_begin < r_end) stage(0, r_begin);
  for (int rb = r_begin; rb < r_end; rb += 64, b ^= 1) {
    if (rb + 64 < r_end) {
      stage(b ^ 1, rb + 64);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile b is in shared memory for every thread
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      uint32_t af[4];
      ldsm_x4_t(af, &pt[b][(kk + (lane & 7) + ((lane >> 4) << 3)) * kT +
                           16 * w + ((lane >> 3) & 1) * 8]);
      if (P.scaled)
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = scale_pair(af[e], P.s);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bf[4];
        ldsm_x4_t(bf, &qt[b][(kk + (lane & 15)) * kT + 16 * p + (lane >> 4) * 8]);
        if (Q.scaled)
#pragma unroll
          for (int e = 0; e < 4; ++e) bf[e] = scale_pair(bf[e], Q.s);
        mma_bf16_16816(acc[2 * p], af, bf[0], bf[1]);
        mma_bf16_16816(acc[2 * p + 1], af, bf[2], bf[3]);
      }
    }
    __syncthreads();  // tile b is consumed before it is staged again
  }
  float* out = part + (size_t)blockIdx.z * N * Kq;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + w * 16 + g + 8 * half, k = k0 + nt * 8 + 2 * t;
      if (n < N && k < Kq) {
        out[(size_t)n * Kq + k] = acc[nt][2 * half];
        out[(size_t)n * Kq + k + 1] = acc[nt][2 * half + 1];
      }
    }
}

// Partials summed in a fixed order, in two levels: group g sums partials
// [g per, (g + 1) per) into the first of them, then out[i] sums the groups'
// firsts in order.
static __global__ void sum_groups_kernel(float* __restrict__ part, int parts,
                                         int per, size_t E) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int p0 = blockIdx.y * per, p1 = min(parts, p0 + per);
  if (i >= E || p0 >= parts) return;
  float s = 0.f;
  for (int p = p0; p < p1; ++p) s += part[(size_t)p * E + i];
  part[(size_t)p0 * E + i] = s;
}

static __global__ void sum_firsts_kernel(const float* __restrict__ part,
                                         int parts, int per, size_t E,
                                         float* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  float s = 0.f;
  for (int p = 0; p < parts; p += per) s += part[(size_t)p * E + i];
  out[i] = s;
}

// out[E] = sum over the `parts` partials [parts][E] (overwrites them).
inline cudaError_t sum_parts(float* part, int parts, size_t E, float* out,
                             cudaStream_t st) {
  const int groups = parts < 64 ? parts : 64;
  const int per = (parts + groups - 1) / groups;
  const unsigned bx = (unsigned)((E + 255) / 256);
  sum_groups_kernel<<<dim3(bx, groups), 256, 0, st>>>(part, parts, per, E);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sum_firsts_kernel<<<bx, 256, 0, st>>>(part, parts, per, E, out);
  return cudaGetLastError();
}

inline cudaError_t wgrad(const MatSrc& P, const MatSrc& Q, int rows, int N, int Kq,
                         int stripes, float* part, float* out,
                         cudaStream_t st) {
  if (P.ld % 8 || Q.ld % 8 || (uintptr_t)P.p % 16 || (uintptr_t)Q.p % 16)
    return cudaErrorMisalignedAddress;
  const int tiles = (rows + 63) / 64;
  const int stripe_rows = (tiles + stripes - 1) / stripes * 64;
  dim3 grid((N + 63) / 64, (Kq + 63) / 64, stripes);
  wgrad_kernel<<<grid, 128, 0, st>>>(P, Q, rows, N, Kq, stripe_rows,
                                             part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_parts(part, stripes, (size_t)N * Kq, out, st);
}

}  // namespace lnk
