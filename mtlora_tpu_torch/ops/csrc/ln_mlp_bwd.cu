// Fused LayerNorm + whole MLP with shared LoRA (backward) for Hopper.
//
// Replaces mtlora_tpu/ops/pallas_ln_mlp.py: _bwd_kernel, launched by
// _bwd_rule, the custom VJP of fused_ln_mlp. With ln, h, g and both masks
// recomputed (never stored), the cast points of _bwd_kernel:
//   dm2 = bf16(bf16(s2 gy) B2)        dg  = bf16(gy) W2 + drop2(dm2 A2^T)
//   dh  = dg gelu'(h) (tanh form)     dln = bf16(dh) W1 + drop1(dm1 A1^T)
//   dm1 = bf16(bf16(s1 dh) B1)
//   dB2^T = bf16(s2 gy)^T m2          dA2^T = dm2^T bf16(drop2(g))
//   dB1^T = bf16(s1 dh)^T m1          dA1^T = dm1^T bf16(drop1(ln))
//   dgamma, dbeta, dx: the LayerNorm backward of dln.
//
// What bounds it: the frozen products (h and dg recomputed, dln; ~3 of
// the forward's two), tensor-core work far above the ridge; the [M, 4C]
// hidden and its gradient never reach device memory. The TPU grid runs in
// order and carries dgamma, dbeta and the four adapter gradients in VMEM;
// here:
//   - a row kernel (a block of 4 warps owns 16 rows) walks the hidden in
//     groups of 4 chunks of 64 columns, one chunk per warp (the rank
//     products of gd and du take their A operands from the registers),
//     and keeps dln in registers, each warp C/4 of its columns; it writes
//     dx, the 16-row partials of dgamma and dbeta, bf16(drop1(ln)),
//     bf16(ln) and the four bf16 [M, 64] rank rows m1, dm1, m2, dm2;
//   - dB1 and dA2 are products over rows of hidden-chunk tensors (du1 and
//     bf16(drop2(g))): a second kernel, one block per (64-column hidden
//     chunk, stripe of rows), recomputes the chunk's h, g and dh from the
//     stored bf16(ln), rank rows and gy, and accumulates both products over
//     its stripe in registers; fp32 partials per stripe (stripes ~ two
//     waves / chunks, so ~8 MB at most) are summed in order;
//   - dA1 and dB2 are products of stored rows (lnk::wgrad), as in
//     ln_lora_bwd.cu.
// Deterministic, with no fp32 atomics. mma.sync m16n8k16 throughout.

#include "ln_common.cuh"

namespace {

using namespace lnk;

struct MlpBwdArgs {
  Rows R;
  const bf16 *gamma, *beta, *w1, *bias1, *a1, *bb1, *a2;
  const bf16 *w2t, *bb2t, *a2t, *w1t, *bb1t, *a1t, *gy;
  bf16 *dx, *lbuf, *lnc, *m1, *dm1, *m2, *dm2;
  float *mu_g, *inv_g, *gb;
  int H4, r;
  float s1, s2;
  DropSpec d1, d2;
};

// h chunk [16, 64] of rows m0.. at hidden columns h0..: bf16(ln) W1^T + b1
// + s1 bf16(m1) B1^T, bf16(ln) and m1 from the rows the row kernel wrote.
__device__ __forceinline__ void hidden_chunk(float (*h)[4],
                                             const MlpBwdArgs& a, int m0,
                                             int valid, int h0) {
  const int C = a.R.K, t = lane_id() & 3;
  float u[8][4];
  zero<8>(h);
  zero<8>(u);
  mma_rows<8, false, 2>(h, a.lnc + (size_t)m0 * C, C, valid, 1.f, a.w1, C,
                        C, h0, a.H4);
  mma_rows<8, false>(u, a.m1 + (size_t)m0 * a.r, a.r, valid, 1.f, a.bb1,
                     a.r, a.r, h0, a.H4);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = h0 + nt * 8 + 2 * t + (e & 1);
      h[nt][e] = (h[nt][e] + __bfloat162float(a.bias1[col])) + a.s1 * u[nt][e];
    }
}

// dg chunk: bf16(gy) W2 + drop2(bf16(dm2) A2^T), dm2 from device rows.
__device__ __forceinline__ void dg_chunk(float (*dg)[4], const MlpBwdArgs& a,
                                         const Drop& d2, int m0, int valid,
                                         int h0) {
  const int C = a.R.K, lane = lane_id(), g = lane >> 2, t = lane & 3;
  float dgd[8][4];
  zero<8>(dg);
  zero<8>(dgd);
  mma_rows<8, false, 2>(dg, a.gy + (size_t)m0 * C, C, valid, 1.f, a.w2t, C,
                        C, h0, a.H4);
  mma_rows<8, false>(dgd, a.dm2 + (size_t)m0 * a.r, a.r, valid, 1.f, a.a2t,
                     a.r, a.r, h0, a.H4);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dg[nt][e] += d2.apply(dgd[nt][e], m0 + g + 8 * (e >> 1), a.H4,
                            h0 + nt * 8 + 2 * t + (e & 1));
}

constexpr int kG = 4 * 64 + 8;     // row stride of the 4-chunk hidden tiles

// Shared memory of a block of the row kernel: LN tile [16][C + 8], m1 and
// dm2 (later dm1) tiles [16][72], m2 tile [16][72], the bf16(dh) tile of
// one group of 4 hidden chunks [16][264] (bf16); the warps' m2 and dm1
// partials [2][4][1024] in fragment order, per-warp row sums [2][4][16],
// mu and inv [16] (fp32).
inline size_t row_block_bytes(int C) {
  return sizeof(bf16) * kRows * ((size_t)(C + 8) + 3 * kT + kG) +
         sizeof(float) * (2 * 4 * 1024 + 2 * 4 * kRows + 2 * kRows);
}

// YT: n-tiles of 8 of the dln columns a warp owns (C / 4 <= 8 YT). Three
// blocks per SM (at most 168 registers, a few spilled) beat two blocks
// without spills on the H100, and four blocks with more spills lose.
template <int YT>
__global__ void __launch_bounds__(128, 3) ln_mlp_bwd_rows(MlpBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.R.K, M = a.R.M, H4 = a.H4, r = a.r, ld = C + 8;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kRows;
  const int valid = min(kRows, M - m0);
  const int cw = C / 4, c_lo = warp * cw;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  bf16* m1t = tile + kRows * ld;
  bf16* dmt = m1t + kRows * kT;       // dm2, later dm1
  bf16* m2t = dmt + kRows * kT;       // m2 at the end
  bf16* dht = m2t + kRows * kT;       // bf16(dh) of the group
  float* m2p = reinterpret_cast<float*>(dht + kRows * kG);
  float* dm1p = m2p + 4 * 1024;
  float* red = dm1p + 4 * 1024;       // [2][4][16]
  float* mu = red + 2 * 4 * kRows;
  float* inv = mu + kRows;
  const int mine = warp * 1024 + lane * 4;
  const bf16* gy = a.gy + (size_t)m0 * C;

  rows_stats(a.R, m0, mu, inv, warp, warps);
  __syncthreads();
  if (threadIdx.x < valid) {
    a.mu_g[m0 + threadIdx.x] = mu[threadIdx.x];
    a.inv_g[m0 + threadIdx.x] = inv[threadIdx.x];
  }
  const Drop d1 = make_drop(a.d1), d2 = make_drop(a.d2);
  // bf16(drop1(ln)) -> the dA1 product's rows; m1 = bf16(tile A1^T) and
  // dm2 = bf16(bf16(s2 gy) B2), 16 columns per warp, to the rank rows
  rows_ln_tile(tile, ld, a.R, a.gamma, a.beta, m0, mu, inv, d1, warp, warps);
  __syncthreads();
  block_tile_to_global(a.lbuf, tile, ld, m0, M, C);
  {
    float acc[2][4];
    zero<2>(acc);
    mma_tile<2>(acc, tile, ld, a.a1, C, C, 16 * warp, r);
    store_tile<2>(m1t, kT, acc, 16 * warp);
    zero<2>(acc);
    mma_rows<2, true>(acc, gy, C, valid, a.s2, a.bb2t, C, C, 16 * warp, r);
    store_tile<2>(dmt, kT, acc, 16 * warp);
  }
  __syncthreads();
  block_tile_to_global(a.m1, m1t, kT, m0, M, r);
  block_tile_to_global(a.dm2, dmt, kT, m0, M, r);
  if (d1.on) {
    __syncthreads();
    rows_ln_tile(tile, ld, a.R, a.gamma, a.beta, m0, mu, inv, no_drop(),
                 warp, warps);
  }
  {
    float z[8][4];
    zero<8>(z);
    store_frag(m2p + mine, z);
    store_frag(dm1p + mine, z);
  }
  __syncthreads();
  block_tile_to_global(a.lnc, tile, ld, m0, M, C);   // for the dB1/dA2 pass

  // the hidden in groups of 4 chunks of 64: warp w recomputes chunk w's h,
  // g, the mask and dh, and adds its shares of m2 and dm1; then every warp
  // adds the group's dh W1[group, :] to the C/4 columns of dln it owns
  float dln[YT][4];
  zero<YT>(dln);
  for (int hg = 0; hg < H4; hg += 4 * 64) {
    const int h0 = hg + 64 * warp;
    if (h0 < H4) {
      float h[8][4], u[8][4], v[8][4];
      zero<8>(h);
      zero<8>(u);
      mma_tile<8, 2>(h, tile, ld, a.w1, C, C, h0, H4);
      mma_tile<8>(u, m1t, kT, a.bb1, r, r, h0, H4);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = h0 + nt * 8 + 2 * t + (e & 1);
          const float hv =
              (h[nt][e] + __bfloat162float(a.bias1[col])) + a.s1 * u[nt][e];
          float gl, dgl;
          act_pair<kGelu>(hv, &gl, &dgl);
          h[nt][e] = dgl;
          u[nt][e] = d2.apply(gl, m0 + g + 8 * (e >> 1), H4, col);
        }
      // m2 share: bf16(drop2(g)) straight from the registers
      load_frag(v, m2p + mine);
      mma_frag<8>(v, u, a.a2 + h0, H4, 0, r);
      store_frag(m2p + mine, v);
      // dg = bf16(gy) W2 + drop2(dm2 A2^T); dh = dg gelu'(h)
      zero<8>(u);
      zero<8>(v);
      mma_rows<8, false, 2>(u, gy, C, valid, 1.f, a.w2t, C, C, h0, H4);
      mma_tile<8>(v, dmt, kT, a.a2t, r, r, h0, H4);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dh =
              (u[nt][e] + d2.apply(v[nt][e], m0 + g + 8 * (e >> 1), H4,
                                   h0 + nt * 8 + 2 * t + (e & 1))) *
              h[nt][e];
          h[nt][e] = dh;
          u[nt][e] = a.s1 * dh;
        }
      store_tile<8>(dht, kG, h, 64 * warp);
      // dm1 share: bf16(s1 dh) straight from the registers
      load_frag(v, dm1p + mine);
      mma_frag<8>(v, u, a.bb1t + h0, H4, 0, r);
      store_frag(dm1p + mine, v);
    }
    __syncthreads();
    mma_tile<YT, 2>(dln, dht, kG, a.w1t + hg, H4, min(4 * 64, H4 - hg),
                    c_lo, c_lo + cw);
    __syncthreads();
  }

  // ---- m2, dm1: the warps' shares summed in order ----------------------
  sum_frags(m2p, warps, m2t, a.m2, m0, M);
  sum_frags(dm1p, warps, dmt, a.dm1, m0, M);
  __syncthreads();

  // ---- dln += drop1(dm1 A1^T); LayerNorm backward on the warp's columns,
  // dxhat in place of dln ------------------------------------------------
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
  float* gb = a.gb + (size_t)blockIdx.x * 2 * C;
#pragma unroll
  for (int j = 0; j < YT; j += 8) {
    float dl[8][4];
    zero<8>(dl);
    mma_tile<8>(dl, dmt, kT, a.a1t, r, r, c_lo + 8 * j, c_lo + cw);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (8 * (j + nt) >= cw) continue;
      const int c = c_lo + 8 * (j + nt) + 2 * t;
      const float2 gm = bf2(a.gamma + c);
      float cg[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        float dh0 = 0.f, dh1 = 0.f;
        if (m < M) {
          const float e0 = dln[j + nt][2 * half] +
                           d1.apply(dl[nt][2 * half], m, C, c);
          const float e1 = dln[j + nt][2 * half + 1] +
                           d1.apply(dl[nt][2 * half + 1], m, C, c + 1);
          const float2 v = a.R.pair(m, c);
          const float xh0 = (v.x - mu[g + 8 * half]) * inv[g + 8 * half];
          const float xh1 = (v.y - mu[g + 8 * half]) * inv[g + 8 * half];
          dh0 = e0 * gm.x;
          dh1 = e1 * gm.y;
          s1[half] += dh0 + dh1;
          s2[half] += dh0 * xh0 + dh1 * xh1;
          cg[0] += e0 * xh0;
          cg[1] += e1 * xh1;
          cb[0] += e0;
          cb[1] += e1;
        }
        dln[j + nt][2 * half] = dh0;
        dln[j + nt][2 * half + 1] = dh1;
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          cg[e] += __shfl_xor_sync(0xffffffffu, cg[e], o);
          cb[e] += __shfl_xor_sync(0xffffffffu, cb[e], o);
        }
      if (g == 0) {
        *reinterpret_cast<float2*>(gb + c) = make_float2(cg[0], cg[1]);
        *reinterpret_cast<float2*>(gb + C + c) = make_float2(cb[0], cb[1]);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s1[half] += __shfl_xor_sync(0xffffffffu, s1[half], o);
      s2[half] += __shfl_xor_sync(0xffffffffu, s2[half], o);
    }
    if (t == 0) {
      red[warp * kRows + g + 8 * half] = s1[half];
      red[(4 + warp) * kRows + g + 8 * half] = s2[half];
    }
  }
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + g + 8 * half;
    float mm1 = 0.f, mm2 = 0.f;
    for (int w = 0; w < warps; ++w) {
      mm1 += red[w * kRows + g + 8 * half];
      mm2 += red[(4 + w) * kRows + g + 8 * half];
    }
    mm1 /= C;
    mm2 /= C;
    if (m >= M) continue;
    const float mn = mu[g + 8 * half], iv = inv[g + 8 * half];
#pragma unroll
    for (int j = 0; j < YT; ++j) {
      if (8 * j >= cw) continue;
      const int c = c_lo + 8 * j + 2 * t;
      const float2 v = a.R.pair(m, c);
      const float xh0 = (v.x - mn) * iv, xh1 = (v.y - mn) * iv;
      st_bf2(a.dx + (size_t)m * C + c,
             iv * (dln[j][2 * half] - mm1 - xh0 * mm2),
             iv * (dln[j][2 * half + 1] - mm1 - xh1 * mm2));
    }
  }
}

// ---------------------------------------------------------------------------
// dB1^T [4C, r] and dA2^T [r, 4C]: one block of 4 warps per (64-column
// hidden chunk, stripe of rows). Per 64 rows each warp recomputes its 16
// rows' h, g, the mask and dh for the chunk from bf16(ln), m1, gy and dm2
// (rows the row kernel wrote), and writes du1 = bf16(s1 dh) and
// bf16(drop2(g)) transposed ([h][row]) beside m1 and dm2 ([j][row]); then
// warp w accumulates dB1^T rows h0 + 16w.. and dA2^T rows 16w.. over the
// rows. Partials [stripe][2][4C * r].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(128, 3)
ln_mlp_bwd_hidden(MlpBwdArgs a, int stripe_rows, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H4 = a.H4, r = a.r;
  const int warp = threadIdx.x >> 5;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int h0 = blockIdx.x * 64;
  const int r_begin = blockIdx.y * stripe_rows;
  const int r_end = min(a.R.M, r_begin + stripe_rows);
  bf16* duT = reinterpret_cast<bf16*>(smem);
  bf16* gdT = duT + 64 * kT;
  bf16* m1T = gdT + 64 * kT;
  bf16* dm2T = m1T + 64 * kT;
  const Drop d2 = make_drop(a.d2);
  const MatSrc m1src{a.m1, r, 1.f, 0}, dm2src{a.dm2, r, 1.f, 0};

  float acc_b[8][4], acc_a[8][4];
  zero<8>(acc_b);
  zero<8>(acc_a);
  for (int rb = r_begin; rb < r_end; rb += 64) {
    const int m0 = rb + warp * kRows;
    const int valid = max(0, min(kRows, r_end - m0));
    __syncthreads();   // the previous rows' tiles are consumed
    stage_t(m1T, m1src, rb, r_end, 0, r);
    stage_t(dm2T, dm2src, rb, r_end, 0, r);
    float h[8][4], dg[8][4];
    hidden_chunk(h, a, m0, valid, h0);
    dg_chunk(dg, a, d2, m0, valid, h0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hl = nt * 8 + 2 * t + (e & 1);
        const int rl = warp * kRows + g + 8 * (e >> 1);
        const int m = rb + rl;
        float gl, dgl;
        act_pair<kGelu>(h[nt][e], &gl, &dgl);
        const bool in = m < r_end;
        gdT[hl * kT + rl] =
            __float2bfloat16(in ? d2.apply(gl, m, H4, h0 + hl) : 0.f);
        duT[hl * kT + rl] =
            __float2bfloat16(in ? a.s1 * (dg[nt][e] * dgl) : 0.f);
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      uint32_t fb[4], fa[4];
      load_a(fb, duT + warp * 16 * kT + kk, kT, g, t);
      load_a(fa, dm2T + warp * 16 * kT + kk, kT, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* pb = m1T + (nt * 8 + g) * kT + kk + 2 * t;
        const bf16* pa = gdT + (nt * 8 + g) * kT + kk + 2 * t;
        mma_bf16_16816(acc_b[nt], fb, ld32(pb), ld32(pb + 8));
        mma_bf16_16816(acc_a[nt], fa, ld32(pa), ld32(pa + 8));
      }
    }
  }
  float* out_b = part + (size_t)blockIdx.y * 2 * H4 * r;   // dB1^T [4C][r]
  float* out_a = out_b + (size_t)H4 * r;                     // dA2^T [r][4C]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp * 16 + g + 8 * half, col = nt * 8 + 2 * t;
      if (col < r) {
        out_b[(size_t)(h0 + row) * r + col] = acc_b[nt][2 * half];
        out_b[(size_t)(h0 + row) * r + col + 1] = acc_b[nt][2 * half + 1];
      }
      if (row < r) {
        out_a[(size_t)row * H4 + h0 + col] = acc_a[nt][2 * half];
        out_a[(size_t)row * H4 + h0 + col + 1] = acc_a[nt][2 * half + 1];
      }
    }
}

}  // namespace

// Layouts: the forward's (w1 [4C, C], a1 [r, C], bb1 [4C, r], a2 [r, 4C])
// and the transposed copies the backward products read: w2t [4C, C],
// bb2t [r, C], a2t [4C, r], w1t [C, 4C], bb1t [r, 4C], a1t [C, r].
// Scratch: stats [2, M] fp32, lbuf [2, M, C] (bf16(drop1(ln)), bf16(ln))
// and mbuf
// [4, M, r] (m1, dm1, m2, dm2) bf16, gb
// [ceil(M/16), 2, C], partials pa [sa, r, C], pb [sb, C, r],
// ph [sh, 2, 4C * r]. Outputs (fp32): dgb [2, C], da1 [r, C],
// dh [2, 4C * r] (dB1^T [4C, r], then dA2^T [r, 4C]), dbb2 [C, r].
extern "C" int mtlora_ln_mlp_bwd(
    const void* x, const void* gamma, const void* beta, const void* w1,
    const void* bias1, const void* a1, const void* bb1, const void* w2,
    const void* bias2, const void* a2, const void* bb2, const void* seed,
    const void* w2t, const void* bb2t, const void* a2t, const void* w1t,
    const void* bb1t, const void* a1t, const void* gy, void* dx, void* stats,
    void* lbuf, void* mbuf, void* gb, void* pa, void* pb, void* ph, void* dgb, void* da1,
    void* dh, void* dbb2, int M, int C, int H4, int r, int sa, int sb,
    int sh, float s1, float s2, unsigned thr, int use_drop, float inv_keep,
    void* stream) {
  (void)w2;
  (void)bias2;
  (void)bb2;
  if (M < 1 || C % 32 || C > 768 || H4 % 64 || r != 64)
    return (int)cudaErrorInvalidValue;
  MlpBwdArgs a;
  a.R.x = static_cast<const bf16*>(x);
  a.R.M = M;
  a.R.K = C;
  a.R.Cin = C;
  a.R.Wh = 0;
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.w1 = static_cast<const bf16*>(w1);
  a.bias1 = static_cast<const bf16*>(bias1);
  a.a1 = static_cast<const bf16*>(a1);
  a.bb1 = static_cast<const bf16*>(bb1);
  a.a2 = static_cast<const bf16*>(a2);
  a.w2t = static_cast<const bf16*>(w2t);
  a.bb2t = static_cast<const bf16*>(bb2t);
  a.a2t = static_cast<const bf16*>(a2t);
  a.w1t = static_cast<const bf16*>(w1t);
  a.bb1t = static_cast<const bf16*>(bb1t);
  a.a1t = static_cast<const bf16*>(a1t);
  a.gy = static_cast<const bf16*>(gy);
  a.dx = static_cast<bf16*>(dx);
  a.lbuf = static_cast<bf16*>(lbuf);
  a.lnc = a.lbuf + (size_t)M * C;
  bf16* mb = static_cast<bf16*>(mbuf);
  a.m1 = mb;
  a.dm1 = mb + (size_t)M * r;
  a.m2 = mb + 2 * (size_t)M * r;
  a.dm2 = mb + 3 * (size_t)M * r;
  a.mu_g = static_cast<float*>(stats);
  a.inv_g = a.mu_g + M;
  a.gb = static_cast<float*>(gb);
  a.H4 = H4;
  a.r = r;
  a.s1 = s1;
  a.s2 = s2;
  for (int s = 0; s < 2; ++s) {
    DropSpec& d = s ? a.d2 : a.d1;
    d.seed = static_cast<const int*>(seed);
    d.stream = s;
    d.on = use_drop;
    d.thr = thr;
    d.inv_keep = inv_keep;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const size_t smem = row_block_bytes(C);
  const int tiles = (M + kRows - 1) / kRows;
  const int yt = C / 32;   // n-tiles of 8 per warp: C / 4 columns
  void (*rows)(MlpBwdArgs) = yt <= 8    ? ln_mlp_bwd_rows<8>
                             : yt <= 16 ? ln_mlp_bwd_rows<16>
                                        : ln_mlp_bwd_rows<24>;
  cudaError_t e = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  rows<<<tiles, 128, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // dB1^T and dA2^T over row stripes
  const int row_tiles = (M + 63) / 64;
  const int stripe_rows = (row_tiles + sh - 1) / sh * 64;
  const size_t smem_h = sizeof(bf16) * 4 * 64 * kT;
  e = cudaFuncSetAttribute(ln_mlp_bwd_hidden,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_h);
  if (e != cudaSuccess) return (int)e;
  ln_mlp_bwd_hidden<<<dim3(H4 / 64, sh), 128, smem_h, st>>>(
      a, stripe_rows, static_cast<float*>(ph));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = sum_parts(static_cast<float*>(ph), sh, 2 * (size_t)H4 * r,
                static_cast<float*>(dh), st);
  if (e != cudaSuccess) return (int)e;

  // dA1^T [r, C] = dm1^T bf16(drop1(ln)); dB2^T [C, r] = bf16(s2 gy)^T m2
  MatSrc ln{a.lbuf, C, 1.f, 0};
  MatSrc dm1src{a.dm1, r, 1.f, 0}, m2src{a.m2, r, 1.f, 0};
  MatSrc du2{a.gy, C, s2, 1};
  e = wgrad(dm1src, ln, M, r, C, sa, static_cast<float*>(pa),
            static_cast<float*>(da1), st);
  if (e != cudaSuccess) return (int)e;
  e = wgrad(du2, m2src, M, C, r, sb, static_cast<float*>(pb),
            static_cast<float*>(dbb2), st);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_parts(a.gb, tiles, 2 * (size_t)C, static_cast<float*>(dgb),
                        st);
}
