// Fused LayerNorm + frozen GEMM + shared LoRA in the stage-tail mode
// (backward) for Hopper: one row kernel, then the weight passes.
//
// Replaces mtlora_tpu/ops/pallas_ln_lora.py: _bwd_kernel (:124) with
// out_act, out_p and out_drop (the GELU recompute :159-181), launched by
// _bwd_rule (:324, call :365), the custom VJP of fused_ln_lora_linear at
// norm2 -> fc1 of the four blocks that carry task streams. With ln, z and
// both hash masks recomputed (stream 0 on ln, stream 1 on y), the cast
// points of _bwd_kernel:
//   z   = bf16(ln) W^T + b + s m B^T     m = bf16(bf16(drop0(ln)) A^T)
//   g   = (gy + drop1(gd)) gelu'(z)      fp32, tanh form (lnk::kGelu);
//                                        no gelu' without act
//   gpt = bf16(g + gp)                   du = bf16(s g)
//   dm  = bf16(du B)                     dln = gpt W + drop0(dm A)
//   dB^T = du^T m                        dA^T = dm^T bf16(drop0(ln))
//   dgamma, dbeta, dx: the LayerNorm backward of dln.
//
// What bounds it: two frozen products (z and dln, 4 M C O FLOP) and six
// rank-64 products, 2 M (2 C O + 3 C r + 3 O r) FLOP, against the bytes
// of gy, gp and gd (6 M O): ~30-150 FLOP a byte, under the card's ~295
// ridge, so the bytes bound it; in this design, as in kernel 4b's, the
// issue and latency of each block's products, copies and mask hashes
// between barriers do. Design (that of ln_mlp_bwd.cu, whose first layer
// this is, on slice_ring.cuh):
//   - a block of 8 warps owns BM rows, so that its dln (BM x C fp32)
//     stays at 96 registers a thread or below: 64, 128 at C = 192 (a
//     warp's 64 columns, more products per fragment), 32 where C > 384
//     (128 registers at C = 1024; the launch plan,
//     ops/ln_lora.py:tail_bwd_plan, chooses). Where
//     C <= 128 two blocks share an SM, so that one's LayerNorm, hashing
//     and barriers overlap the other's products. The 32-row blocks are few
//     (1.5 waves at stage 3): the two blocks of a cluster share one row
//     block, each taking half of its hidden chunks, and the second hands
//     its dln and dm partials to the first through device memory;
//   - its rows of x arrive by cp.async at once, for the row statistics and
//     the LN tiles (read row by row from device memory, they kept a block
//     waiting on one load after another), and again for the LayerNorm
//     backward. It keeps bf16(drop0(ln)), then bf16(ln), m, then dm, and
//     stream 0's mask (bytes, hashed once for the tile and dl) in shared
//     memory;
//   - the block walks its hidden columns in 64-column chunks. Per chunk,
//     B's [64 x r] slice and W's [64 x C] slices stream through a ring of
//     kStages [64 x 64] slices filled by cp.async, kGroup slices per
//     barrier (A's slices before and after the chunks); z = s m B^T +
//     bf16(ln) W^T accumulates in the warps' registers, and the slices are
//     kept in shared memory for the chunk's dm += du B and dln += gpt W:
//     every weight byte is staged once per block. Above C = 768 W's
//     slices do not fit beside the bf16(ln) tile: they stream through
//     the ring again for dln (B's slice is still kept). A rank r < 64 is
//     zero-filled to 64 (A's rows and B's columns past r read as zero, so
//     m, u, dm and dl take no part of them), and m and dm go to their rows
//     at r's stride. Each thread loads its
//     elements of the chunk's gy, gp and gd into registers as the chunk
//     starts, to use them after its z products (bulk copies of 128-byte
//     rows to shared memory, and a lead of a whole chunk, cost more than
//     they hid); g, gpt and du are formed in registers and written to
//     shared tiles, from which the products read them and du goes to its
//     rows;
//   - the products: mma.sync m16n8k16 with both operands from ldmatrix
//     (ldmatrix.trans for the transposed uses of a slice; dln's gpt
//     fragments loaded once for all of C);
//   - the row kernel writes dx, the per-block partials of dgamma and
//     dbeta, and the rows that the weight products read: bf16(drop0(ln))
//     [M, C], m and dm [M, r], du [M, O] (bf16). dA and dB are lnk::wgrad
//     products over them; fp32 partials per stripe of rows are summed in
//     a fixed order. Deterministic, no fp32 atomics.

#include "row_block.cuh"

namespace {

using namespace lnk;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 64;               // a slice and a hidden chunk: 64 wide
constexpr int kLdS = kS + 8;         // row stride of the 64-wide tiles
constexpr int kStages = 4;           // ring depth
constexpr int kGroup = 2;            // slices per ring barrier
constexpr int kRank = 64;           // the rank's slice (r <= 64)
static_assert(kS == kSliceW, "slice_ring.cuh");

struct Args {
  Rows R;  // x [M, C]
  const bf16 *gamma, *beta, *wt, *bias, *at, *bt, *gy, *gp, *gd;
  bf16 *dx, *lnd, *m, *dm, *du;
  float* gb;
  float* xfer;  // split 2: the second block's dln and dm partials
  int O, r, act;
  int split2;   // 1: the two blocks of a cluster share a row block
  int per;      // slices a hidden chunk: B and W's ncs (2 ncs + 1 where W
                // streams again for dln)
  int per_mul;  // ceil(2^16 / per): q / per = q per_mul >> 16
  float s;
  DropSpec d0, d1;
};

// The hidden chunks of a block: nch of them from j0, all O / 64, or in a
// cluster of two the half of the block's rank.
struct Chunks {
  int j0, nch;
};

__device__ __forceinline__ Chunks chunks_of(const Args& a) {
  const int n = (a.O >> 6) >> a.split2;
  return Chunks{n * (int)(blockIdx.x & a.split2), n};
}

// The q-th slice a block multiplies with (ncs slices of 64 columns of C):
// A for m; per hidden chunk B (u, then dm), W (z, then dln; streamed a
// second time for dln where per = 2 ncs + 1); A for dl. A's rows and B's
// columns past r read as zero.
__device__ __forceinline__ Slice slice_of(const Args& a, int q, int ncs) {
  const int C = a.R.K;
  const Chunks ch = chunks_of(a);
  if (q < ncs) return Slice{a.at, C, 0, kS * q, a.r, C};         // m
  q -= ncs;
  const int j = (q * a.per_mul) >> 16;   // q / per, exact for q < 2^16 / per
  if (j < ch.nch) {
    const int h0 = kS * (ch.j0 + j), i = q - j * a.per;
    if (i == 0) return Slice{a.bt, a.r, h0, 0, a.O, a.r};        // u, dm
    const int cs = i - 1 < ncs ? i - 1 : i - 1 - ncs;
    return Slice{a.wt, C, h0, kS * cs, a.O, C};                  // z, dln
  }
  q -= ch.nch * a.per;
  return Slice{a.at, C, 0, kS * q, a.r, C};                      // dl
}

// A warp's elements of a chunk's [M, O] cotangent in the accumulator
// layout (n-tile nt, row half h: row m0 + g + 8 h, columns c0 + 8 nt +
// 2 t..), as bf16 pairs; rows past M, or no cotangent (src null), are 0.
template <int NT>
__device__ __forceinline__ void cot_in(uint32_t (*v)[2], const bf16* src,
                                       int O, int m0, int M, int c0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + g + 8 * h;
      v[nt][h] = src && m < M
                     ? __ldg(reinterpret_cast<const unsigned*>(
                           src + (size_t)m * O + c0 + 8 * nt + 2 * t))
                     : 0u;
    }
}

// gelu'(z) of the tanh form (lnk::act_pair<kGelu>'s derivative), tanh(u)
// taken as 1 - 2 / (exp(2u) + 1) with __expf and __fdividef: within about
// 1e-7 of tanhf, without its branch.
static_assert(kGelu == Act::Tanh, "gelu_grad is the tanh form's");

__device__ __forceinline__ float gelu_grad(float z) {
  const float z2 = z * z;
  const float u = z * (kGeluC + kGeluCD * z2);
  const float th = 1.f - __fdividef(2.f, __expf(2.f * u) + 1.f);
  return 0.5f * (1.f + th) +
         0.5f * z * (1.f - th * th) * (kGeluC + 3.f * kGeluCD * z2);
}

__device__ __forceinline__ float2 unpack_bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// A block of BM rows (128, 64 or 32) whose dln covers at most NCS slices
// of 64 columns. Where C <= 128 two blocks share an SM (at most 128
// registers, a few spilled), so that one block's LayerNorm and mask
// hashing overlap the other's products. Above 12 slices (C > 768) the
// block keeps no W slices: they stream again for dln.
template <int BM, int NCS>
__global__ void __launch_bounds__(kThreads, NCS <= 2 ? 2 : 1)
    ln_lora_tail_bwd_rows(Args a) {
  constexpr int WM = BM / 16, WN = kWarps / WM;
  constexpr int NT = kS / 8 / WN;   // n-tiles of a warp in a 64-wide product
  constexpr int kTile = BM * kLdS;
  constexpr bool kKeepW = NCS <= 12;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.R.K, M = a.R.M, O = a.O, ld = C + 8;
  const int ncs = (C + kS - 1) / kS;
  const Chunks ch = chunks_of(a);
  const int nch = ch.nch, rank = blockIdx.x & a.split2;
  const int warp = threadIdx.x >> 5, lane = lane_id(), g = lane >> 2,
            t = lane & 3;
  const int mi = warp % WM, ni = warp / WM;
  const int wr = kRows * mi, wc = 8 * NT * ni;   // the warp's rows, columns
  const int m0 = (blockIdx.x >> a.split2) * BM;
  // Dynamic shared memory: the ring, the bf16(ln) tile [BM][C + 8], the
  // m / dm tile [BM][72], the chunk's kept W slices (none above C = 768)
  // and B slice, its du and gpt tiles [BM][72] (bf16; before and after
  // the chunks the span from the W slices on, at least [BM][C + 8], holds
  // the block's rows of x); mu, inv [BM] and the row sums of the
  // LayerNorm backward [2][WN][BM] (fp32). The padded row strides keep
  // ldmatrix free of bank conflicts.
  SliceRing<Args, kThreads, kStages, kGroup> ring{
      reinterpret_cast<bf16*>(smem), 0, 2 * ncs + nch * a.per, ncs};
  bf16* lt = ring.buf + kStages * kSliceElems;   // bf16(drop0(ln)), bf16(ln)
  bf16* mt = lt + BM * ld;                       // m, then dm
  bf16* wk = mt + kTile;                         // W slices of the chunk
  bf16* bk = wk + (kKeepW ? ncs : 0) * kSliceElems;   // B slice of the chunk
  bf16* dut = bk + kSliceElems;                  // du of the chunk
  bf16* gpt = dut + kTile;                       // gpt of the chunk
  float* mu = reinterpret_cast<float*>(
      gpt + kTile < wk + BM * ld ? wk + BM * ld : gpt + kTile);
  float* inv = mu + BM;
  float* red = inv + BM;                         // [2][WN][BM]
  // stream 0's mask over the block's ln [BM][C], 1 where kept
  uint8_t* kb = reinterpret_cast<uint8_t*>(red + 2 * WN * BM);
  // the plan's bytes (ops/ln_lora.py:tail_bwd_plan) must hold this layout
  if (kb + BM * C - smem >
      dynamic_smem_bytes())
    __trap();

  // The block's rows of x by cp.async, in the group of the first slice
  x_in<BM, kThreads>(wk, ld, a.R, m0);
  ring.start(a);
  cp_async_wait<0>();
  __syncthreads();
  const TileRows xs{wk, M, C, ld, m0};
  for (int i = 0; i < BM; i += kRows)
    rows_stats(xs, m0 + i, mu + i, inv + i, warp, kWarps);
  __syncthreads();
  const Drop d0 = make_drop(a.d0), d1 = make_drop(a.d1);
  // bf16(drop0(ln)), as rows_ln_tile computes it, and the mask's bytes
  // for dl (hashed once)
  for (int i = warp; i < BM; i += kWarps) {
    const int m = m0 + i;
    for (int k = 2 * lane; k < C; k += 64) {
      float v0 = 0.f, v1 = 0.f;
      bool k0 = true, k1 = true;
      if (m < M) {
        const float2 xv = xs.pair(m, k), gm = bf2(a.gamma + k),
                     be = bf2(a.beta + k);
        v0 = ln_val(xv.x, mu[i], inv[i], gm.x, be.x);
        v1 = ln_val(xv.y, mu[i], inv[i], gm.y, be.y);
        if (d0.on) {
          k0 = drop_keep(d0.key, m, C, k, d0.thr);
          k1 = drop_keep(d0.key, m, C, k + 1, d0.thr);
          v0 = k0 ? v0 * d0.inv_keep : 0.f;
          v1 = k1 ? v1 * d0.inv_keep : 0.f;
        }
      }
      st_bf2(lt + i * ld + k, v0, v1);
      *reinterpret_cast<uint16_t*>(kb + i * C + k) =
          (uint16_t)(k0 | (k1 << 8));
    }
  }

  // ---- m = bf16(bf16(drop0(ln)) A^T) ---------------------------------------
  {
    float acc[NT][4];
    zero<NT>(acc);
    for (int cs = 0; cs < ncs; ++cs)
      mma_sl<NT, false>(acc, lt + wr * ld + kS * cs, ld, ring.next(a), wc,
                        ksteps(C, cs));
    store_tile<NT>(mt + wr * kLdS, kLdS, acc, wc);
  }
  if (rank == 0) rows_out<kThreads>(a.lnd, C, 0, lt, ld, m0, M, BM, C);
  __syncthreads();
  if (d0.on)
    for (int i = 0; i < BM; i += kRows)
      rows_ln_tile(lt + i * ld, ld, xs, a.gamma, a.beta, m0 + i, mu + i,
                   inv + i, no_drop(), warp, kWarps);
  if (rank == 0) rows_out<kThreads>(a.m, a.r, 0, mt, kLdS, m0, M, BM, a.r);

  // ---- the hidden in chunks of 64 columns ---------------------------------
  float dln[NCS][NT][4], dma[NT][4];
#pragma unroll
  for (int cs = 0; cs < NCS; ++cs) zero<NT>(dln[cs]);
  zero<NT>(dma);
  for (int j = 0; j < nch; ++j) {
    const int h0 = kS * (ch.j0 + j);
    // the chunk's gy, gp, gd into registers, used after its products (gp
    // and gd a slice later: fewer registers held across the first one)
    uint32_t cur[3][NT][2];
    cot_in<NT>(cur[0], a.gy, O, m0 + wr, M, h0 + wc);
    // z = s m B^T + bf16(ln) W^T (+ b below); the slices kept, past
    // chunk j - 1's products on their copies
    float zc[NT][4];
    zero<NT>(zc);
    __syncthreads();
    {
      const bf16* sl = ring.next(a);
      mma_sl<NT, false>(zc, mt + wr * kLdS, kLdS, sl, wc, 4);
      for (int v = threadIdx.x; v < kSliceElems / 8; v += kThreads)
        reinterpret_cast<uint4*>(bk)[v] = reinterpret_cast<const uint4*>(sl)[v];
      cot_in<NT>(cur[1], a.gp, O, m0 + wr, M, h0 + wc);
      cot_in<NT>(cur[2], a.gd, O, m0 + wr, M, h0 + wc);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) zc[nt][e] *= a.s;
    for (int cs = 0; cs < ncs; ++cs) {
      const bf16* sl = ring.next(a);
      mma_sl<NT, false>(zc, lt + wr * ld + kS * cs, ld, sl, wc, ksteps(C, cs));
      if constexpr (kKeepW)
        for (int v = threadIdx.x; v < kSliceElems / 8; v += kThreads)
          reinterpret_cast<uint4*>(wk + cs * kSliceElems)[v] =
              reinterpret_cast<const uint4*>(sl)[v];
    }
    // g = (gy + drop1(gd)) gelu'(z); gpt = bf16(g + gp), du = bf16(s g)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int cl = wc + 8 * nt + 2 * t, col = h0 + cl;
      const float2 b = bf2(a.bias + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wr + g + 8 * half, m = m0 + rl, o = rl * kLdS + cl;
        float dg0 = 1.f, dg1 = 1.f;
        if (a.act) {
          dg0 = gelu_grad(zc[nt][2 * half] + b.x);
          dg1 = gelu_grad(zc[nt][2 * half + 1] + b.y);
        }
        float2 gv = unpack_bf2(cur[0][nt][half]);
        if (a.gd) {
          const float2 dv = unpack_bf2(cur[2][nt][half]);
          gv.x += d1.apply(dv.x, m, O, col);
          gv.y += d1.apply(dv.y, m, O, col + 1);
        }
        gv.x *= dg0;
        gv.y *= dg1;
        const float2 pv = unpack_bf2(cur[1][nt][half]);
        st_bf2(gpt + o, gv.x + pv.x, gv.y + pv.y);
        st_bf2(dut + o, a.s * gv.x, a.s * gv.y);
      }
    }
    __syncthreads();   // the chunk's du, gpt tiles and kept slices
    rows_out<kThreads>(a.du, O, h0, dut, kLdS, m0, M, BM, kS);
    // dm += du B; dln += gpt W
    mma_sl<NT, true>(dma, dut + wr * kLdS, kLdS, bk, wc, 4);
    uint32_t af[kS / 16][4];
    a_frags(af, gpt + wr * kLdS, kLdS, 4);
    if constexpr (kKeepW) {
#pragma unroll
      for (int cs = 0; cs < NCS; ++cs)
        if (cs < ncs && kS * cs + wc < C)
          mma_frags<NT, true>(dln[cs], af, wk + cs * kSliceElems, wc, 4);
    } else {
#pragma unroll
      for (int cs = 0; cs < NCS; ++cs)
        if (cs < ncs) {
          const bf16* sl = ring.next(a);
          if (kS * cs + wc < C) mma_frags<NT, true>(dln[cs], af, sl, wc, 4);
        }
    }
  }

  // ---- a split-2 cluster: the second block's dln and dm partials to the
  // first, through device memory, in fragment order (coalesced) ------------
  if (BM == 32 && a.split2) {
    // [row block][(ncs + 1) NT 4 values][thread]: dln's slices, then dm
    float* xf = a.xfer + (size_t)(blockIdx.x / 2) * (ncs + 1) * NT * 4 *
                             kThreads + threadIdx.x;
    float* xm = xf + (size_t)ncs * NT * 4 * kThreads;
    if (rank == 1) {
#pragma unroll
      for (int cs = 0; cs < NCS; ++cs)
        if (cs < ncs)
#pragma unroll
          for (int v = 0; v < NT * 4; ++v)
            xf[(cs * NT * 4 + v) * kThreads] = dln[cs][v / 4][v % 4];
#pragma unroll
      for (int v = 0; v < NT * 4; ++v) xm[v * kThreads] = dma[v / 4][v % 4];
    }
    cluster_sync();
    if (rank == 1) {
      cp_async_wait<0>();
      return;
    }
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs)
      if (cs < ncs)
#pragma unroll
        for (int v = 0; v < NT * 4; ++v)
          dln[cs][v / 4][v % 4] += xf[(cs * NT * 4 + v) * kThreads];
#pragma unroll
    for (int v = 0; v < NT * 4; ++v) dma[v / 4][v % 4] += xm[v * kThreads];
  }

  // ---- dm to its rows and over m (last read before the chunks' last
  // barriers); dln += drop0(bf16(dm) A) ---------------------------------
  {
    const int m = m0 + wr + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = wc + 8 * nt + 2 * t;
      if (c >= a.r) continue;
      if (m < M) st_bf2(a.dm + (size_t)m * a.r + c, dma[nt][0], dma[nt][1]);
      if (m + 8 < M)
        st_bf2(a.dm + (size_t)(m + 8) * a.r + c, dma[nt][2], dma[nt][3]);
    }
  }
  store_tile<NT>(mt + wr * kLdS, kLdS, dma, wc);
  // past the last chunk's products: the rows of x again, for the
  // LayerNorm backward (from device memory it waits on one load after
  // another)
  __syncthreads();
  x_in<BM, kThreads>(wk, ld, a.R, m0);
#pragma unroll
  for (int cs = 0; cs < NCS; ++cs)
    if (cs < ncs) {
      const bf16* sl = ring.next(a);
      if (kS * cs + wc < C) {
        float dl[NT][4];
        zero<NT>(dl);
        mma_sl<NT, true>(dl, mt + wr * kLdS, kLdS, sl, wc, 4);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint16_t kk = *reinterpret_cast<const uint16_t*>(
                kb + (wr + g + 8 * h) * C + kS * cs + wc + 8 * nt + 2 * t);
            const float ik = d0.on ? d0.inv_keep : 1.f;
            dln[cs][nt][2 * h] += (kk & 1) ? dl[nt][2 * h] * ik : 0.f;
            dln[cs][nt][2 * h + 1] += (kk >> 8) ? dl[nt][2 * h + 1] * ik : 0.f;
          }
      }
    }

  // ---- LayerNorm backward: dx; the 16-row partials of dgamma and dbeta
  // into the ring's slots [WM][2][C], then their sum over the block's rows
  cp_async_wait<0>();
  __syncthreads();
  float* gbs = reinterpret_cast<float*>(ring.buf);
  ln_bwd_rows<BM, NCS, NT, WN>(dln, xs, a.gamma, mu, inv, red,
                               gbs + mi * 2 * C, a.dx, m0, mi, ni, ncs);
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) {
    float v = 0.f;
    for (int w = 0; w < WM; ++w) v += gbs[w * 2 * C + c];
    a.gb[(size_t)(m0 / BM) * 2 * C + c] = v;
  }
}

// blocks row blocks of one block each, or two (a cluster) with split2
template <int BM, int NCS>
cudaError_t launch_rows(const Args& a, int blocks, int smem,
                        cudaStream_t st) {
  auto kern = ln_lora_tail_bwd_rows<BM, NCS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (!a.split2) {
    kern<<<blocks, kThreads, smem, st>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 2;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// Layouts: the forward's (wt [O, C], bias [O], at [r, C], bt [O, r]; r 16,
// 32, 48 or 64), read in place; gy, gp, gd [M, O] (gp, gd may be null: no
// cotangent). bm (128 where C = 192, 64 up to C = 384, or 32), split (the
// blocks
// of a cluster that share a row block's hidden chunks: 2 where bm = 32,
// or 1) and the row kernel's shared-memory bytes smem are the caller's
// launch plan (ops/ln_lora.py:tail_bwd_plan); the kernel traps if smem
// does not hold its layout. Scratch: lnd [M, C], mbuf [2, M, r] (m, dm),
// du [M, O] bf16; gb [ceil(M / bm), 2, C], the weight-gradient
// partials part (sa stripes of [r, C], then sb of [O, r]) and, with split
// 2, xfer [ceil(M / bm), (ceil(C / 64) + 1) 8, 256] fp32. Outputs: dx;
// dgb [2, C], dat [r, C], dbt [O, r] (fp32). use_drop: both hash streams
// at threshold thr.
extern "C" int mtlora_ln_lora_tail_bwd(
    const void* x, const void* gamma, const void* beta, const void* wt,
    const void* bias, const void* at, const void* bt, const void* seed,
    const void* gy, const void* gp, const void* gd, void* dx, void* lnd,
    void* mbuf, void* du, void* gb, void* part, void* xfer, void* dgb,
    void* dat, void* dbt, int M, int C, int O, int r, int act, int bm,
    int split, int smem, int sa, int sb, float scale, unsigned thr,
    int use_drop, float inv_keep, void* stream) {
  const int ncs = (C + kS - 1) / kS;
  if (M < 1 || C <= kS || C % 32 || C > 1024 || O < kS || O % kS ||
      r < 16 || r % 16 || r > kRank || sa < 1 || sb < 1 ||
      !(bm == 32 || (bm == 64 && ncs <= 6) || (bm == 128 && C == 192)) ||
      !(split == 1 || (split == 2 && bm == 32 && O / kS % 2 == 0 && xfer)))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies: cp.async of x and the weights, the tiles' stores (the
  // cotangents are read 4 bytes at a time)
  if (misaligned(x) || misaligned(wt) || misaligned(at) || misaligned(bt) ||
      misaligned(lnd) || misaligned(mbuf) || misaligned(du))
    return (int)cudaErrorMisalignedAddress;
  Args a;
  a.R.x = static_cast<const bf16*>(x);
  a.R.M = M;
  a.R.K = C;
  a.R.Cin = C;
  a.R.Wh = 0;
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.wt = static_cast<const bf16*>(wt);
  a.bias = static_cast<const bf16*>(bias);
  a.at = static_cast<const bf16*>(at);
  a.bt = static_cast<const bf16*>(bt);
  a.gy = static_cast<const bf16*>(gy);
  a.gp = static_cast<const bf16*>(gp);
  a.gd = static_cast<const bf16*>(gd);
  a.dx = static_cast<bf16*>(dx);
  a.lnd = static_cast<bf16*>(lnd);
  a.m = static_cast<bf16*>(mbuf);
  a.dm = a.m + (size_t)M * r;
  a.du = static_cast<bf16*>(du);
  a.gb = static_cast<float*>(gb);
  a.xfer = static_cast<float*>(xfer);
  a.split2 = split == 2;
  a.per = ncs <= 12 ? ncs + 1 : 2 * ncs + 1;   // the instances' kKeepW
  a.per_mul = (65536 + a.per - 1) / a.per;
  a.O = O;
  a.r = r;
  a.act = act;
  a.s = scale;
  for (int s = 0; s < 2; ++s) {
    DropSpec& d = s ? a.d1 : a.d0;
    d.seed = static_cast<const int*>(seed);
    d.stream = s;
    d.on = use_drop;
    d.thr = thr;
    d.inv_keep = inv_keep;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const int blocks = (M + bm - 1) / bm;
  cudaError_t e = bm == 32    ? (ncs <= 12
                                     ? launch_rows<32, 12>(a, blocks, smem, st)
                                     : launch_rows<32, 16>(a, blocks, smem, st))
                  : bm == 128 ? launch_rows<128, 3>(a, blocks, smem, st)
                  : ncs <= 2  ? launch_rows<64, 2>(a, blocks, smem, st)
                  : ncs <= 3  ? launch_rows<64, 3>(a, blocks, smem, st)
                              : launch_rows<64, 6>(a, blocks, smem, st);
  if (e != cudaSuccess) return (int)e;

  // dA^T [r, C] = dm^T bf16(drop0(ln)); dB^T [O, r] = du^T m
  float* pp = static_cast<float*>(part);
  const MatSrc lnds{a.lnd, C, 1.f, 0}, ms{a.m, r, 1.f, 0};
  const MatSrc dms{a.dm, r, 1.f, 0}, dus{a.du, O, 1.f, 0};
  e = wgrad(dms, lnds, M, r, C, sa, pp, static_cast<float*>(dat), st);
  if (e != cudaSuccess) return (int)e;
  e = wgrad(dus, ms, M, O, r, sb, pp, static_cast<float*>(dbt), st);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_parts(a.gb, blocks, 2 * (size_t)C,
                        static_cast<float*>(dgb), st);
}
