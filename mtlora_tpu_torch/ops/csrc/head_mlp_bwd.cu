// Fused HRNet decode head (backward) for Hopper.
//
// Replaces mtlora_tpu/ops/pallas_head.py: _bwd_kernel, launched by
// _bwd_rule, the custom VJP of fused_head_mlp. With the forward's
// hidden recomputed per row block (never stored):
//   hc   = bf16(x We + be)                zpre = bf16(bf16(hc*mul) + add)
//   z    = relu(zpre)                     dz   = bf16(gy) Wp^T      (fp32)
//   dzp  = dz where zpre > 0              dh   = dzp * mul          (fp32 mul)
//   dhc  = bf16(dh)
//   dx   = dhc We^T     dWe = x^T dhc     dWp = z^T bf16(gy)
//   dbe  = sum dh       dmul = sum dzp*hc dadd = sum dzp    dbp = sum gy
// with every product accumulated in fp32, the cast points of _bwd_kernel.
//
// What bounds it: five products of M x 270 x 1080 (two recomputing the
// hidden), ~290 FLOP per byte of x and gy: near the card's ridge, bound
// by how well mma.sync is fed. The TPU kernel keeps the [M, 1080] hidden
// out of HBM (217 MB in bf16 at batch 32); this one does too.
//
// The TPU grid runs in order and carries dWe [270, 1080], dWp [1080, n]
// and four row vectors in VMEM from step to step. Blocks on the H100 run
// in parallel, so the work is split in two kernels that each recompute
// the hidden:
//   - dx: one block per 64 rows walks the hidden in 64-column chunks, as
//     the forward does, and keeps the [64, 270] dx sum in registers: the
//     sum over chunks stays inside one block, so there is no race;
//   - weights: one block per (64-column chunk of the hidden, stripe of
//     rows) computes the chunk's hidden TRANSPOSED ([hidden, rows]), so
//     dhc and z come out hidden-major, and accumulates its slices of
//     dWe^T [64, 270], dWp^T [n, 64] and the three vectors in registers
//     over its stripe; it writes them as fp32 partials [stripes, ...]
//     (1.2 MB of dWe a stripe; the stripe count is about SMs / chunks,
//     so the partials stay at ~8 MB at any batch);
//   - a third, small kernel sums the stripes in a fixed order and casts:
//     deterministic, with no fp32 atomics.
// All products are mma.sync m16n8k16 (bf16 in, fp32 accumulate). C = 270
// and n in {1, 3, 7, 21} are zero-padded in shared memory (to 272 and to
// a multiple of 16) and the stores are masked. Operands that the product
// needs transposed are gathered from shared memory two bf16 at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kBM = 64;       // rows per tile
constexpr int kHC = 64;       // hidden columns per chunk
constexpr int kWarps = 8;
constexpr int kNMax = 64;     // outputs n
constexpr int kCMax = 272;    // padded inputs C (34 n-tiles of 8)
constexpr int kCT = kCMax / 16;  // n-tiles of 8 per warp half: 17
constexpr int kZld = kHC + 8;

struct Shapes {
  int M, cin, hidden, n_out;
  int Kp, xld, NP, gld;
};

__device__ __forceinline__ Shapes shapes(int M, int cin, int hidden,
                                         int n_out) {
  Shapes s;
  s.M = M;
  s.cin = cin;
  s.hidden = hidden;
  s.n_out = n_out;
  s.Kp = (cin + 15) / 16 * 16;
  s.xld = s.Kp + 8;
  s.NP = (n_out + 15) / 16 * 16;
  s.gld = s.NP + 8;
  return s;
}

// x rows [r0, r1) of the tile starting at r0, zero-padded to kBM x Kp.
__device__ __forceinline__ void stage_x(__nv_bfloat16* xs,
                                        const __nv_bfloat16* x,
                                        const Shapes& s, int r0, int r1) {
  const uint32_t* xg = reinterpret_cast<const uint32_t*>(x);
  const int kw = s.Kp / 2, cw = s.cin / 2;
  for (int i = threadIdx.x; i < kBM * kw; i += blockDim.x) {
    const int r = i / kw;
    const int c = i - r * kw;
    const int gr = r0 + r;
    uint32_t val = 0;
    if (gr < r1 && c < cw) val = xg[(size_t)gr * cw + c];
    reinterpret_cast<uint32_t*>(xs + r * s.xld)[c] = val;
  }
}

// gy rows [r0, r1) as gys[r][o], zero-padded to kBM x NP (n may be odd,
// so the rows are read element by element).
__device__ __forceinline__ void stage_gy(__nv_bfloat16* gys,
                                         const __nv_bfloat16* gy,
                                         const Shapes& s, int r0, int r1) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < kBM * s.NP; i += blockDim.x) {
    const int r = i / s.NP;
    const int o = i - r * s.NP;
    const int gr = r0 + r;
    gys[r * s.gld + o] = (gr < r1 && o < s.n_out)
                             ? gy[(size_t)gr * s.n_out + o] : zero;
  }
}

// The chunk's weights: es[j][c] = We^T[j0+j][c], pks[j][o] = Wp^T[o][j0+j],
// and the vectors eb, bf16(mul), bf16(add), mul.
__device__ __forceinline__ void stage_chunk(
    __nv_bfloat16* es, __nv_bfloat16* pks, float* vec,
    const __nv_bfloat16* ek_t, const __nv_bfloat16* pk_t, const float* eb,
    const float* mul, const float* add, const Shapes& s, int j0) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const uint32_t* eg = reinterpret_cast<const uint32_t*>(ek_t);
  const int kw = s.Kp / 2, cw = s.cin / 2;
  for (int i = threadIdx.x; i < kHC * kw; i += blockDim.x) {
    const int jr = i / kw;
    const int c = i - jr * kw;
    const int gj = j0 + jr;
    uint32_t val = 0;
    if (gj < s.hidden && c < cw) val = eg[(size_t)gj * cw + c];
    reinterpret_cast<uint32_t*>(es + jr * s.xld)[c] = val;
  }
  for (int i = threadIdx.x; i < s.NP * kHC; i += blockDim.x) {
    const int o = i / kHC;
    const int jr = i - o * kHC;
    const int gj = j0 + jr;
    pks[jr * s.gld + o] = (o < s.n_out && gj < s.hidden)
                              ? pk_t[(size_t)o * s.hidden + gj] : zero;
  }
  for (int i = threadIdx.x; i < kHC; i += blockDim.x) {
    const int gj = j0 + i;
    const bool in = gj < s.hidden;
    vec[i] = in ? eb[gj] : 0.f;
    vec[kHC + i] = in ? round_bf16(mul[gj]) : 0.f;
    vec[2 * kHC + i] = in ? round_bf16(add[gj]) : 0.f;
    vec[3 * kHC + i] = in ? mul[gj] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// dx: one block per 64 rows, the hidden walked in chunks.
// Warp (wm, wn): rows wm*16..+16; hidden columns wn*32..+32 of the chunk for
// h and dz, input columns wn*136..+136 for dx.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kWarps * 32, 1)
head_bwd_dx_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ ek_t,
                   const float* __restrict__ eb,
                   const float* __restrict__ mul,
                   const float* __restrict__ add,
                   const __nv_bfloat16* __restrict__ pk_t,
                   const __nv_bfloat16* __restrict__ gy,
                   __nv_bfloat16* __restrict__ dx,
                   int M, int cin, int hidden, int n_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Shapes s = shapes(M, cin, hidden, n_out);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* es = xs + kBM * s.xld;
  __nv_bfloat16* ecs = es + kHC * s.xld;      // [Kp][kZld]: We[c][j]
  __nv_bfloat16* pks = ecs + s.Kp * kZld;
  __nv_bfloat16* gys = pks + kHC * s.gld;
  __nv_bfloat16* dhs = gys + kBM * s.gld;     // [kBM][kZld]: dhc[r][j]
  float* vec = reinterpret_cast<float*>(dhs + kBM * kZld);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int row0 = blockIdx.x * kBM;
  const int NTc = s.Kp / 8;

  stage_x(xs, x, s, row0, M);
  stage_gy(gys, gy, s, row0, M);

  float dxa[kCT][4];
#pragma unroll
  for (int i = 0; i < kCT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dxa[i][e] = 0.f;

  for (int j0 = 0; j0 < hidden; j0 += kHC) {
    __syncthreads();  // previous chunk consumed
    stage_chunk(es, pks, vec, ek_t, pk_t, eb, mul, add, s, j0);
    for (int i = tid; i < kHC * s.Kp; i += blockDim.x) {
      const int jr = i / s.Kp;
      const int c = i - jr * s.Kp;
      const int gj = j0 + jr;
      ecs[c * kZld + jr] = (gj < hidden && c < cin)
                               ? ek_t[(size_t)gj * cin + c]
                               : __float2bfloat16(0.f);
    }
    __syncthreads();

    // ---- h = x We and dz = gy Wp^T on this warp's 16 x 32 tile ------------
    float ha[4][4], dza[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ha[nt][e] = dza[nt][e] = 0.f;
    for (int kk = 0; kk < s.Kp; kk += 16) {
      uint32_t a[4];
      load_a(a, xs + wm * 16 * s.xld + kk, s.xld, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* b = es + (wn * 32 + nt * 8 + g) * s.xld + kk + 2 * t;
        mma_bf16_16816(ha[nt], a, ld32(b), ld32(b + 8));
      }
    }
    for (int kk = 0; kk < s.NP; kk += 16) {
      uint32_t a[4];
      load_a(a, gys + wm * 16 * s.gld + kk, s.gld, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* b = pks + (wn * 32 + nt * 8 + g) * s.gld + kk + 2 * t;
        mma_bf16_16816(dza[nt], a, ld32(b), ld32(b + 8));
      }
    }

    // ---- ReLU mask and BN-affine backward -> bf16 dhc tile ----------------
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 16 + g + half * 8;
        const int col = wn * 32 + nt * 8 + 2 * t;
        float d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = col + e;
          const float hc = round_bf16(ha[nt][half * 2 + e] + vec[j]);
          const float zp = round_bf16(round_bf16(hc * vec[kHC + j]) +
                                      vec[2 * kHC + j]);
          const float dzp = zp > 0.f ? dza[nt][half * 2 + e] : 0.f;
          d[e] = dzp * vec[3 * kHC + j];
        }
        *reinterpret_cast<__nv_bfloat162*>(dhs + r * kZld + col) =
            __floats2bfloat162_rn(d[0], d[1]);
      }
    }
    __syncthreads();

    // ---- dx += dhc We^T ----------------------------------------------------
#pragma unroll
    for (int kk = 0; kk < kHC; kk += 16) {
      uint32_t a[4];
      load_a(a, dhs + wm * 16 * kZld + kk, kZld, g, t);
#pragma unroll
      for (int nt = 0; nt < kCT; ++nt) {
        const int ct = wn * kCT + nt;
        if (ct < NTc) {
          const __nv_bfloat16* b = ecs + (ct * 8 + g) * kZld + kk + 2 * t;
          mma_bf16_16816(dxa[nt], a, ld32(b), ld32(b + 8));
        }
      }
    }
  }

  // ---- dx rows, masked bf16 stores ------------------------------------------
#pragma unroll
  for (int nt = 0; nt < kCT; ++nt) {
    const int col = (wn * kCT + nt) * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wm * 16 + g + half * 8;
      if (r < M && col < cin)
        *reinterpret_cast<__nv_bfloat162*>(dx + (size_t)r * cin + col) =
            __floats2bfloat162_rn(dxa[nt][half * 2], dxa[nt][half * 2 + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Weight gradients: one block per (chunk of 64 hidden columns, stripe of
// rows), everything hidden-major. Warp (wm, wn): hidden rows wm*16..+16;
// tile rows wn*32..+32 for h^T and dz^T, input columns wn*136..+136 for
// dWe^T; warp w owns hidden columns w*8..+8 of dWp^T.
// Partials, per stripe, at offsets of E = hidden*cin + n*hidden +
// 3*hidden + n floats: dWe^T [hidden][cin], dWp^T [n][hidden],
// (dbe, dmul, dadd) [3][hidden], dbp [n].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kWarps * 32, 1)
head_bwd_w_kernel(const __nv_bfloat16* __restrict__ x,
                  const __nv_bfloat16* __restrict__ ek_t,
                  const float* __restrict__ eb,
                  const float* __restrict__ mul,
                  const float* __restrict__ add,
                  const __nv_bfloat16* __restrict__ pk_t,
                  const __nv_bfloat16* __restrict__ gy,
                  float* __restrict__ part,
                  int M, int cin, int hidden, int n_out, int stripe_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Shapes s = shapes(M, cin, hidden, n_out);
  __nv_bfloat16* es = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* pks = es + kHC * s.xld;
  __nv_bfloat16* xs = pks + kHC * s.gld;
  __nv_bfloat16* gys = xs + kBM * s.xld;
  __nv_bfloat16* zT = gys + kBM * s.gld;      // [kHC][kZld]: z[r][j] at [j][r]
  __nv_bfloat16* dT = zT + kHC * kZld;        // [kHC][kZld]: dhc at [j][r]
  float* vec = reinterpret_cast<float*>(dT + kHC * kZld);
  float* red = vec + 4 * kHC;                 // [2][kHC][3]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int j0 = blockIdx.x * kHC;
  const int stripe = blockIdx.y;
  const int r_begin = stripe * stripe_rows;
  const int r_end = min(M, r_begin + stripe_rows);
  const int NTc = s.Kp / 8;
  const int MTo = s.NP / 16;
  const size_t E = (size_t)hidden * cin + (size_t)n_out * hidden +
                   3 * (size_t)hidden + n_out;
  float* out = part + (size_t)stripe * E;

  stage_chunk(es, pks, vec, ek_t, pk_t, eb, mul, add, s, j0);

  float dwe[kCT][4], dwp[kNMax / 16][4];
#pragma unroll
  for (int i = 0; i < kCT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dwe[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < kNMax / 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dwp[i][e] = 0.f;
  float sums[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  float dbp = 0.f;

  for (int rb = r_begin; rb < r_end; rb += kBM) {
    __syncthreads();  // previous tile consumed (and the chunk staged)
    stage_x(xs, x, s, rb, r_end);
    stage_gy(gys, gy, s, rb, r_end);
    __syncthreads();

    // ---- h^T = We^T x^T and dz^T = Wp gy^T on this warp's 16 x 32 tile ----
    float ha[4][4], dza[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ha[nt][e] = dza[nt][e] = 0.f;
    for (int kk = 0; kk < s.Kp; kk += 16) {
      uint32_t a[4];
      load_a(a, es + wm * 16 * s.xld + kk, s.xld, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* b = xs + (wn * 32 + nt * 8 + g) * s.xld + kk + 2 * t;
        mma_bf16_16816(ha[nt], a, ld32(b), ld32(b + 8));
      }
    }
    for (int kk = 0; kk < s.NP; kk += 16) {
      uint32_t a[4];
      load_a(a, pks + wm * 16 * s.gld + kk, s.gld, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* b = gys + (wn * 32 + nt * 8 + g) * s.gld + kk + 2 * t;
        mma_bf16_16816(dza[nt], a, ld32(b), ld32(b + 8));
      }
    }

    // ---- z^T, dhc^T and the column sums -----------------------------------
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = wm * 16 + g + half * 8;
      const float ebj = vec[j], mb = vec[kHC + j], ab = vec[2 * kHC + j];
      const float mf = vec[3 * kHC + j];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = wn * 32 + nt * 8 + 2 * t;
        float z[2], d[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hc = round_bf16(ha[nt][half * 2 + e] + ebj);
          const float zp = round_bf16(round_bf16(hc * mb) + ab);
          const float dzp = zp > 0.f ? dza[nt][half * 2 + e] : 0.f;
          z[e] = fmaxf(zp, 0.f);
          d[e] = dzp * mf;
          sums[half][0] += d[e];
          sums[half][1] += dzp * hc;
          sums[half][2] += dzp;
        }
        *reinterpret_cast<__nv_bfloat162*>(zT + j * kZld + r) =
            __floats2bfloat162_rn(z[0], z[1]);
        *reinterpret_cast<__nv_bfloat162*>(dT + j * kZld + r) =
            __floats2bfloat162_rn(d[0], d[1]);
      }
    }
    if (blockIdx.x == 0 && tid < n_out)
      for (int r = 0; r < kBM; ++r) dbp += __bfloat162float(gys[r * s.gld + tid]);
    __syncthreads();

    // ---- dWe^T[j][c] += dhc^T[j][r] x[r][c] -------------------------------
#pragma unroll
    for (int kk = 0; kk < kBM; kk += 16) {
      uint32_t a[4];
      load_a(a, dT + wm * 16 * kZld + kk, kZld, g, t);
#pragma unroll
      for (int nt = 0; nt < kCT; ++nt) {
        const int ct = wn * kCT + nt;
        if (ct < NTc) {
          const __nv_bfloat16* b = xs + (kk + 2 * t) * s.xld + ct * 8 + g;
          mma_bf16_16816(dwe[nt], a, ld_pair(b, s.xld),
                         ld_pair(b + 8 * s.xld, s.xld));
        }
      }
    }
    // ---- dWp^T[o][j] += gy^T[o][r] z[r][j] --------------------------------
#pragma unroll
    for (int kk = 0; kk < kBM; kk += 16) {
      const __nv_bfloat16* b = zT + (warp * 8 + g) * kZld + kk + 2 * t;
      const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
#pragma unroll
      for (int mt = 0; mt < kNMax / 16; ++mt) {
        if (mt < MTo) {
          const __nv_bfloat16* q = gys + (kk + 2 * t) * s.gld + mt * 16 + g;
          uint32_t a[4];
          a[0] = ld_pair(q, s.gld);
          a[1] = ld_pair(q + 8, s.gld);
          a[2] = ld_pair(q + 8 * s.gld, s.gld);
          a[3] = ld_pair(q + 8 * s.gld + 8, s.gld);
          mma_bf16_16816(dwp[mt], a, b0, b1);
        }
      }
    }
  }

  // ---- partials ---------------------------------------------------------------
#pragma unroll
  for (int nt = 0; nt < kCT; ++nt) {
    const int c = (wn * kCT + nt) * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gj = j0 + wm * 16 + g + half * 8;
      if (gj < hidden && c < cin) {
        out[(size_t)gj * cin + c] = dwe[nt][half * 2];
        out[(size_t)gj * cin + c + 1] = dwe[nt][half * 2 + 1];
      }
    }
  }
  float* out_wp = out + (size_t)hidden * cin;
#pragma unroll
  for (int mt = 0; mt < kNMax / 16; ++mt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = mt * 16 + g + (e >= 2 ? 8 : 0);
      const int gj = j0 + warp * 8 + 2 * t + (e & 1);
      if (mt < MTo && o < n_out && gj < hidden)
        out_wp[(size_t)o * hidden + gj] = dwp[mt][e];
    }
  }
  // column sums: the 4 lanes of a row group, then the two warp halves
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float v = sums[half][k];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0) red[(wn * kHC + wm * 16 + g + half * 8) * 3 + k] = v;
    }
  __syncthreads();
  float* out_vec = out_wp + (size_t)n_out * hidden;
  for (int i = tid; i < 3 * kHC; i += blockDim.x) {
    const int k = i / kHC;
    const int j = i - k * kHC;
    if (j0 + j < hidden)
      out_vec[(size_t)k * hidden + j0 + j] =
          red[j * 3 + k] + red[(kHC + j) * 3 + k];
  }
  if (blockIdx.x == 0 && tid < n_out) out_vec[3 * (size_t)hidden + tid] = dbp;
}

// Sum the stripes in order; cast dWe^T and dWp^T to bf16.
__global__ void head_bwd_reduce_kernel(const float* __restrict__ part,
                                       int stripes, int cin, int hidden,
                                       int n_out,
                                       __nv_bfloat16* __restrict__ dek_t,
                                       __nv_bfloat16* __restrict__ dpk_t,
                                       float* __restrict__ deb,
                                       float* __restrict__ dmul,
                                       float* __restrict__ dadd,
                                       float* __restrict__ dpb) {
  const size_t E = (size_t)hidden * cin + (size_t)n_out * hidden +
                   3 * (size_t)hidden + n_out;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  float v = 0.f;
  for (int st = 0; st < stripes; ++st) v += part[(size_t)st * E + i];
  size_t k = i;
  if (k < (size_t)hidden * cin) { dek_t[k] = __float2bfloat16(v); return; }
  k -= (size_t)hidden * cin;
  if (k < (size_t)n_out * hidden) { dpk_t[k] = __float2bfloat16(v); return; }
  k -= (size_t)n_out * hidden;
  if (k < (size_t)hidden) { deb[k] = v; return; }
  if (k < 2 * (size_t)hidden) { dmul[k - hidden] = v; return; }
  if (k < 3 * (size_t)hidden) { dadd[k - 2 * hidden] = v; return; }
  dpb[k - 3 * hidden] = v;
}

}  // namespace

extern "C" int mtlora_head_mlp_bwd(const void* x, const void* ek_t,
                                   const void* eb, const void* mul,
                                   const void* add, const void* pk_t,
                                   const void* gy, void* dx, void* part,
                                   void* dek_t, void* deb, void* dmul,
                                   void* dadd, void* dpk_t, void* dpb, int M,
                                   int cin, int hidden, int n_out,
                                   int stripes, void* stream) {
  if (n_out < 1 || n_out > kNMax || (cin & 1) || cin > kCMax ||
      (hidden & 1) || stripes < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int Kp = (cin + 15) / 16 * 16;
  const int NP = (n_out + 15) / 16 * 16;
  const size_t bf = sizeof(__nv_bfloat16);

  const size_t smem_dx = bf * ((size_t)(kBM + kHC) * (Kp + 8) +
                               (size_t)Kp * kZld +
                               (size_t)(kHC + kBM) * (NP + 8) +
                               (size_t)kBM * kZld) +
                         sizeof(float) * 4 * kHC;
  cudaError_t e = cudaFuncSetAttribute(
      head_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dx);
  if (e != cudaSuccess) return (int)e;
  head_bwd_dx_kernel<<<(M + kBM - 1) / kBM, kWarps * 32, smem_dx, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(ek_t), static_cast<const float*>(eb),
      static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<const __nv_bfloat16*>(pk_t),
      static_cast<const __nv_bfloat16*>(gy), static_cast<__nv_bfloat16*>(dx),
      M, cin, hidden, n_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int tiles = (M + kBM - 1) / kBM;
  const int stripe_rows = (tiles + stripes - 1) / stripes * kBM;
  const size_t smem_w = bf * ((size_t)(kHC + kBM) * (Kp + 8) +
                              (size_t)(kHC + kBM) * (NP + 8) +
                              2 * (size_t)kHC * kZld) +
                        sizeof(float) * (4 * kHC + 6 * kHC);
  e = cudaFuncSetAttribute(head_bwd_w_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_w);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((hidden + kHC - 1) / kHC, stripes);
  head_bwd_w_kernel<<<grid, kWarps * 32, smem_w, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(ek_t), static_cast<const float*>(eb),
      static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<const __nv_bfloat16*>(pk_t),
      static_cast<const __nv_bfloat16*>(gy), static_cast<float*>(part), M,
      cin, hidden, n_out, stripe_rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t E = (size_t)hidden * cin + (size_t)n_out * hidden +
                   3 * (size_t)hidden + n_out;
  head_bwd_reduce_kernel<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(part), stripes, cin, hidden, n_out,
      static_cast<__nv_bfloat16*>(dek_t), static_cast<__nv_bfloat16*>(dpk_t),
      static_cast<float*>(deb), static_cast<float*>(dmul),
      static_cast<float*>(dadd), static_cast<float*>(dpb));
  return (int)cudaGetLastError();
}
