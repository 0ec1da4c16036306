// Fused LayerNorm + whole MLP with shared LoRA (backward) for Hopper.
//
// Replaces mtlora_tpu/ops/pallas_ln_mlp.py: _bwd_kernel (:103), launched by
// _bwd_rule (:276, call :292), the custom VJP of fused_ln_mlp. With ln, h
// and g recomputed and both masks re-hashed, the cast points of _bwd_kernel:
//   dm2 = bf16(bf16(s2 gy) B2)        dg  = bf16(gy) W2 + drop2(dm2 A2^T)
//   dh  = dg gelu'(h) (tanh form)     dln = bf16(dh) W1 + drop1(dm1 A1^T)
//   dm1 = bf16(bf16(s1 dh) B1)
//   dB2^T = bf16(s2 gy)^T m2          dA2^T = dm2^T bf16(drop2(g))
//   dB1^T = bf16(s1 dh)^T m1          dA1^T = dm1^T bf16(drop1(ln))
//   dgamma, dbeta, dx: the LayerNorm backward of dln.
//
// What bounds it: by operations, three frozen products (h recomputed, dg,
// dln), 24 M C^2 against ~6 M C bytes of activations, far above the
// card's ridge. In this design it is latency: every block streams the
// frozen weights (up to 24 C^2 bytes) through shared memory in 8 KB
// slices, so a call moves up to 24 M C^2 / BM bytes from L2, and the 8
// warps of a block meet at a barrier per slice (chip_smoke.py prints the
// slice rate per stage). Design:
//   - a row kernel: a block of 8 warps owns BM rows (64; 32 where C > 384,
//     so that the block's dln, BM x C fp32, stays at 96 registers a
//     thread: the launch plan, ops/ln_mlp.py:bwd_plan, chooses) and keeps
//     its A operands resident in shared memory:
//     bf16(drop1(ln)) then bf16(ln), bf16(gy), the rank rows m1 and dm2,
//     and per 64-column hidden chunk bf16(drop2(g)), du1 = bf16(s1 dh) and
//     bf16(dh);
//   - every weight operand streams through a ring of kStages [64 x 64]
//     slices filled by cp.async, kStages - 1 slices ahead of the one the
//     warps multiply: A1 (m1) and B2 (dm2) before the chunks; per chunk
//     B1 (h's LoRA term), W1 (h), A2 (m2 and dgd), W2 (dg), B1 (dm1), W1
//     (dln, unless the plan keeps the h pass's W1 slices); A1 (dl)
//     after them. A slice is stored as 8 x 8 core matrices, which
//     ldmatrix reads either way round without bank conflicts, so every
//     weight is read in its module layout and no transposed copy exists.
//     Each staged byte serves BM rows, four times as many as the 16 of the
//     first port;
//   - the products: mma.sync m16n8k16 with both operands from ldmatrix
//     (ldmatrix.trans for the transposed uses of a slice). A warp owns 16
//     rows and 64 / WN columns of every [64 x 64] product: h, gelu'(h), dg
//     and the masks of a chunk stay in its registers, m2, dm1 and dln
//     accumulate there;
//   - the row kernel writes dx, the per-16-row partials of dgamma and
//     dbeta, bf16(drop1(ln)), m1, dm1, m2, dm2 and the chunks' du1 and
//     bf16(drop2(g)) as bf16 [M, 4C] rows: dB1, dA2, dA1 and dB2 are then
//     products over rows of stored tensors (lnk::wgrad), with no second
//     recompute of the hidden; fp32 partials per stripe of rows are summed
//     in a fixed order. Deterministic, no fp32 atomics.

#include "slice_ring.cuh"

namespace {

using namespace lnk;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 64;               // a slice: 64 x 64 bf16
constexpr int kLdS = kS + 8;         // row stride of the 64-wide tiles
constexpr int kSlice = kS * kS;      // elements of one ring slot
constexpr int kStages = 4;           // ring depth
constexpr int kRank = 64;
static_assert(kS == kSliceW && kSlice == kSliceElems, "slice_ring.cuh");

struct Args {
  Rows R;  // x [M, C]
  const bf16 *gamma, *beta, *w1, *bias1, *a1, *bb1, *w2, *a2, *bb2, *gy;
  bf16 *dx, *lnd, *m1, *dm1, *m2, *dm2, *du1, *gd;
  float* gb;
  int H4;
  int keep_w1;  // the chunk's W1 slices kept from h for dln
  float s1, s2;
  DropSpec d1, d2;
};

// The q-th slice a block multiplies with (ncs slices of 64 columns of C).
__device__ __forceinline__ Slice slice_of(const Args& a, int q, int ncs) {
  const int C = a.R.K, H4 = a.H4, per = (a.keep_w1 ? 2 : 3) * ncs + 3;
  if (q < ncs) return Slice{a.a1, C, 0, kS * q, kRank, C};         // m1
  q -= ncs;
  if (q < ncs) return Slice{a.bb2, kRank, kS * q, 0, C, kRank};    // dm2
  q -= ncs;
  const int j = q / per;
  if (j < H4 / kS) {
    const int h0 = kS * j;
    int i = q - j * per;
    if (i == 0) return Slice{a.bb1, kRank, h0, 0, H4, kRank};      // u
    i -= 1;
    if (i < ncs) return Slice{a.w1, C, h0, kS * i, H4, C};         // h
    i -= ncs;
    if (i == 0) return Slice{a.a2, H4, 0, h0, kRank, H4};          // m2, dgd
    i -= 1;
    if (i < ncs) return Slice{a.w2, H4, kS * i, h0, C, H4};        // dg
    i -= ncs;
    if (i == 0) return Slice{a.bb1, kRank, h0, 0, H4, kRank};      // dm1
    return Slice{a.w1, C, h0, kS * (i - 1), H4, C};                // dln
  }
  q -= (H4 / kS) * per;
  return Slice{a.a1, C, 0, kS * q, kRank, C};                      // dl
}

__device__ __forceinline__ float dropped(float v, bool keep, const Drop& d) {
  return d.on ? (keep ? v * d.inv_keep : 0.f) : v;
}

// A block of BM rows (64 or 32) whose dln covers at most NCS slices of 64
// columns. Where C <= 128 two blocks share an SM (at most 128 registers,
// a few spilled): the blocks are short there, and one block's LayerNorm
// and first slices overlap the other's products (faster than one block
// without spills: tools/ln_mlp_bwd_variants.py, one-block-per-sm).
template <int BM, int NCS>
__global__ void __launch_bounds__(kThreads, NCS <= 2 ? 2 : 1)
    ln_mlp_bwd_rows(Args a) {
  constexpr int WM = BM / 16, WN = kWarps / WM;
  constexpr int NT = kS / 8 / WN;   // n-tiles of a warp in a 64-wide product
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.R.K, M = a.R.M, H4 = a.H4, ld = C + 8;
  const int ncs = (C + kS - 1) / kS, nch = H4 / kS;
  const int warp = threadIdx.x >> 5, lane = lane_id(), g = lane >> 2,
            t = lane & 3;
  const int mi = warp % WM, ni = warp / WM;
  const int wr = kRows * mi, wc = 8 * NT * ni;   // the warp's rows, columns
  const int m0 = blockIdx.x * BM;
  const bool kept_w1 = a.keep_w1;
  // Dynamic shared memory: the ring, the kept W1 slices, the bf16(ln) and
  // gy tiles [BM][C + 8], the tiles m1, dm2, g, du1, dh [BM][72] (bf16);
  // mu, inv [BM] and the row sums of the LayerNorm backward [2][WN][BM]
  // (fp32). The padded row strides keep ldmatrix free of bank conflicts.
  SliceRing<Args, kThreads, kStages> ring{reinterpret_cast<bf16*>(smem), 0,
            3 * ncs + nch * ((kept_w1 ? 2 : 3) * ncs + 3), ncs};
  bf16* w1k = ring.buf + kStages * kSlice;  // the chunk's W1 slices
  bf16* lt = w1k + (kept_w1 ? ncs * kSlice : 0);  // bf16(drop1(ln)), bf16(ln)
  bf16* gt = lt + BM * ld;                  // gy
  bf16* m1t = gt + BM * ld;
  bf16* dm2t = m1t + BM * kLdS;
  bf16* gdt = dm2t + BM * kLdS;             // bf16(drop2(g)), then dm1
  bf16* dut = gdt + BM * kLdS;              // du1 of the chunk
  bf16* dht = dut + BM * kLdS;              // bf16(dh) of the chunk
  float* mu = reinterpret_cast<float*>(dht + BM * kLdS);
  float* inv = mu + BM;
  float* red = inv + BM;                    // [2][WN][BM]
  // the plan's bytes (ops/ln_mlp.py:bwd_plan) must hold this layout
  if (reinterpret_cast<unsigned char*>(red + 2 * WN * BM) - smem >
      dynamic_smem_bytes())
    __trap();

  // gy and the first slices stream in while the statistics are computed
  {
    const int vc = C / 8;
    for (int v = threadIdx.x; v < BM * vc; v += kThreads) {
      const int i = v / vc, c = (v - i * vc) * 8;
      const bool in = m0 + i < M;
      cp_async16(gt + i * ld + c, in ? a.gy + (size_t)(m0 + i) * C + c : a.gy,
                 in);
    }
    cp_async_commit();
  }
  ring.start(a);
  for (int i = 0; i < BM; i += kRows)
    rows_stats(a.R, m0 + i, mu + i, inv + i, warp, kWarps);
  __syncthreads();
  const Drop d1 = make_drop(a.d1), d2 = make_drop(a.d2);
  for (int i = 0; i < BM; i += kRows)
    rows_ln_tile(lt + i * ld, ld, a.R, a.gamma, a.beta, m0 + i, mu + i,
                 inv + i, d1, warp, kWarps);

  // ---- m1 = bf16(bf16(drop1(ln)) A1^T), dm2 = bf16(bf16(s2 gy) B2) -------
  {
    float acc[NT][4];
    zero<NT>(acc);
    for (int cs = 0; cs < ncs; ++cs)
      mma_sl<NT, false>(acc, lt + wr * ld + kS * cs, ld, ring.next(a), wc,
                        ksteps(C, cs));
    store_tile<NT>(m1t + wr * kLdS, kLdS, acc, wc);
    zero<NT>(acc);
    for (int cs = 0; cs < ncs; ++cs)
      mma_sl<NT, true, true>(acc, gt + wr * ld + kS * cs, ld, ring.next(a),
                             wc, ksteps(C, cs), a.s2);
    store_tile<NT>(dm2t + wr * kLdS, kLdS, acc, wc);
  }
  // the last read of bf16(drop1(ln)) as an operand was before the barrier
  // of the dm2 slices
  rows_out<kThreads>(a.lnd, C, 0, lt, ld, m0, M, BM, C);
  __syncthreads();
  if (d1.on)
    for (int i = 0; i < BM; i += kRows)
      rows_ln_tile(lt + i * ld, ld, a.R, a.gamma, a.beta, m0 + i, mu + i,
                   inv + i, no_drop(), warp, kWarps);
  rows_out<kThreads>(a.m1, kRank, 0, m1t, kLdS, m0, M, BM, kRank);
  rows_out<kThreads>(a.dm2, kRank, 0, dm2t, kLdS, m0, M, BM, kRank);

  // ---- the hidden in chunks of 64 columns ---------------------------------
  // Tiles written in a chunk are read after the next ring barrier; every
  // tile is rewritten only after a ring barrier that follows its last read.
  float dln[NCS][NT][4], m2a[NT][4], dm1a[NT][4];
#pragma unroll
  for (int cs = 0; cs < NCS; ++cs) zero<NT>(dln[cs]);
  zero<NT>(m2a);
  zero<NT>(dm1a);
  for (int j = 0; j < nch; ++j) {
    const int h0 = kS * j;
    // h = s1 m1 B1^T + bf16(ln) W1^T + b1; g, gelu'(h), the mask
    float hc[NT][4];
    zero<NT>(hc);
    mma_sl<NT, false>(hc, m1t + wr * kLdS, kLdS, ring.next(a), wc, 4);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hc[nt][e] *= a.s1;
    for (int cs = 0; cs < ncs; ++cs) {
      const bf16* sl = ring.next(a);
      mma_sl<NT, false>(hc, lt + wr * ld + kS * cs, ld, sl, wc, ksteps(C, cs));
      if (kept_w1)
        for (int v = threadIdx.x; v < kSlice / 8; v += kThreads)
          reinterpret_cast<uint4*>(w1k + cs * kSlice)[v] =
              reinterpret_cast<const uint4*>(sl)[v];
    }
    float gd[NT][4];
    uint32_t keep = 0;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = h0 + wc + 8 * nt + 2 * t + (e & 1);
        const float hv = hc[nt][e] + __bfloat162float(a.bias1[col]);
        float gl, dgl;
        act_pair<kGelu>(hv, &gl, &dgl);
        const bool k =
            !d2.on || drop_keep(d2.key, m0 + wr + g + 8 * (e >> 1), H4, col,
                                d2.thr);
        keep |= (uint32_t)k << (4 * nt + e);
        hc[nt][e] = dgl;
        gd[nt][e] = dropped(gl, k, d2);
      }
    store_tile<NT>(gdt + wr * kLdS, kLdS, gd, wc);
    // m2 += bf16(drop2(g)) A2^T; dg starts at drop2(bf16(dm2) A2^T)
    float dg[NT][4];
    {
      const bf16* sl = ring.next(a);
      mma_sl<NT, false>(m2a, gdt + wr * kLdS, kLdS, sl, wc, 4);
      zero<NT>(dg);
      mma_sl<NT, true>(dg, dm2t + wr * kLdS, kLdS, sl, wc, 4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dg[nt][e] = dropped(dg[nt][e], (keep >> (4 * nt + e)) & 1u, d2);
      rows_out<kThreads>(a.gd, H4, h0, gdt, kLdS, m0, M, BM, kS);
    }
    // dg += bf16(gy) W2; dh = dg gelu'(h)
    for (int cs = 0; cs < ncs; ++cs)
      mma_sl<NT, true>(dg, gt + wr * ld + kS * cs, ld, ring.next(a), wc,
                       ksteps(C, cs));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dh = dg[nt][e] * hc[nt][e];
        hc[nt][e] = dh;
        dg[nt][e] = a.s1 * dh;
      }
    store_tile<NT>(dht + wr * kLdS, kLdS, hc, wc);
    store_tile<NT>(dut + wr * kLdS, kLdS, dg, wc);
    // dm1 += du1 B1; dln += bf16(dh) W1
    mma_sl<NT, true>(dm1a, dut + wr * kLdS, kLdS, ring.next(a), wc, 4);
    rows_out<kThreads>(a.du1, H4, h0, dut, kLdS, m0, M, BM, kS);
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs)
      if (cs < ncs) {
        const bf16* sl = kept_w1 ? w1k + cs * kSlice : ring.next(a);
        if (kS * cs + wc < C)
          mma_sl<NT, true>(dln[cs], dht + wr * kLdS, kLdS, sl, wc, 4);
      }
  }

  // ---- m2, dm1 to their rows; dln += drop1(bf16(dm1) A1) ------------------
  {
    const int m = m0 + wr + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = wc + 8 * nt + 2 * t;
      if (m < M) {
        st_bf2(a.m2 + (size_t)m * kRank + c, m2a[nt][0], m2a[nt][1]);
        st_bf2(a.dm1 + (size_t)m * kRank + c, dm1a[nt][0], dm1a[nt][1]);
      }
      if (m + 8 < M) {
        st_bf2(a.m2 + (size_t)(m + 8) * kRank + c, m2a[nt][2], m2a[nt][3]);
        st_bf2(a.dm1 + (size_t)(m + 8) * kRank + c, dm1a[nt][2], dm1a[nt][3]);
      }
    }
  }
  // into the g tile, last read before the W2 slices' barriers (the du1
  // tile may still be in use: the kept W1 slices need no barrier)
  store_tile<NT>(gdt + wr * kLdS, kLdS, dm1a, wc);
#pragma unroll
  for (int cs = 0; cs < NCS; ++cs)
    if (cs < ncs) {
      const bf16* sl = ring.next(a);
      if (kS * cs + wc < C) {
        float dl[NT][4];
        zero<NT>(dl);
        mma_sl<NT, true>(dl, gdt + wr * kLdS, kLdS, sl, wc, 4);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dln[cs][nt][e] += d1.apply(dl[nt][e], m0 + wr + g + 8 * (e >> 1),
                                       C, kS * cs + wc + 8 * nt + 2 * t + (e & 1));
      }
    }

  // ---- LayerNorm backward: dxhat = dln gamma in place of dln; the warp's
  // 16-row partials of dgamma and dbeta; the rows' sums over the warps ----
  float rs1[2] = {0.f, 0.f}, rs2[2] = {0.f, 0.f};
  float* gb = a.gb + ((size_t)blockIdx.x * WM + mi) * 2 * C;
#pragma unroll
  for (int cs = 0; cs < NCS; ++cs) {
    if (cs >= ncs || kS * cs + wc >= C) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = kS * cs + wc + 8 * nt + 2 * t;
      const float2 gm = bf2(a.gamma + c);
      float cg[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wr + g + 8 * half, m = m0 + rl;
        float v0 = 0.f, v1 = 0.f;
        if (m < M) {
          const float e0 = dln[cs][nt][2 * half], e1 = dln[cs][nt][2 * half + 1];
          const float2 xv = a.R.pair(m, c);
          const float xh0 = (xv.x - mu[rl]) * inv[rl];
          const float xh1 = (xv.y - mu[rl]) * inv[rl];
          v0 = e0 * gm.x;
          v1 = e1 * gm.y;
          rs1[half] += v0 + v1;
          rs2[half] += v0 * xh0 + v1 * xh1;
          cg[0] += e0 * xh0;
          cg[1] += e1 * xh1;
          cb[0] += e0;
          cb[1] += e1;
        }
        dln[cs][nt][2 * half] = v0;
        dln[cs][nt][2 * half + 1] = v1;
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
      rs1[half] += __shfl_xor_sync(0xffffffffu, rs1[half], o);
      rs2[half] += __shfl_xor_sync(0xffffffffu, rs2[half], o);
    }
    if (t == 0) {
      red[ni * BM + wr + g + 8 * half] = rs1[half];
      red[(WN + ni) * BM + wr + g + 8 * half] = rs2[half];
    }
  }
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wr + g + 8 * half, m = m0 + rl;
    float mm1 = 0.f, mm2 = 0.f;
    for (int w = 0; w < WN; ++w) {
      mm1 += red[w * BM + rl];
      mm2 += red[(WN + w) * BM + rl];
    }
    mm1 /= C;
    mm2 /= C;
    if (m >= M) continue;
    const float mn = mu[rl], iv = inv[rl];
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs) {
      if (cs >= ncs || kS * cs + wc >= C) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = kS * cs + wc + 8 * nt + 2 * t;
        const float2 xv = a.R.pair(m, c);
        const float xh0 = (xv.x - mn) * iv, xh1 = (xv.y - mn) * iv;
        st_bf2(a.dx + (size_t)m * C + c,
               iv * (dln[cs][nt][2 * half] - mm1 - xh0 * mm2),
               iv * (dln[cs][nt][2 * half + 1] - mm1 - xh1 * mm2));
      }
    }
  }
}

template <int BM, int NCS>
cudaError_t launch_rows(const Args& a, int blocks, int smem,
                        cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      ln_mlp_bwd_rows<BM, NCS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  ln_mlp_bwd_rows<BM, NCS><<<blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// Layouts: the forward's (w1 [4C, C], a1 [r, C], bb1 [4C, r], w2 [C, 4C],
// a2 [r, 4C], bb2 [C, r]), read in place. bm (64 where C <= 384, or 32),
// keep_w1 and the row kernel's shared-memory bytes smem are the caller's
// launch plan (ops/ln_mlp.py:bwd_plan); the kernel traps if smem does not
// hold its layout. Scratch: lnd [M, C], mbuf [4, M, r] (m1, dm1, m2, dm2),
// hbuf [2, M, 4C] (du1, bf16(drop2(g))) bf16; gb [ceil(M / bm) bm / 16,
// 2, C] and the weight-gradient partials part (sa stripes of [r, C] or
// [C, r], sh of [4C, r] or [r, 4C], one product at a time) fp32. Outputs
// (fp32): dgb [2, C], da1 [r, C], dh [2, 4C * r] (dB1^T [4C, r], then
// dA2^T [r, 4C]), dbb2 [C, r].
extern "C" int mtlora_ln_mlp_bwd(
    const void* x, const void* gamma, const void* beta, const void* w1,
    const void* bias1, const void* a1, const void* bb1, const void* w2,
    const void* a2, const void* bb2, const void* seed, const void* gy,
    void* dx, void* lnd, void* mbuf, void* hbuf, void* gb, void* part,
    void* dgb, void* da1, void* dh, void* dbb2, int M, int C, int H4, int r,
    int bm, int keep_w1, int smem, int sa, int sh, float s1, float s2,
    unsigned thr, int use_drop, float inv_keep, void* stream) {
  const int ncs = (C + kS - 1) / kS;
  if (M < 1 || C < 32 || C % 32 || C > 768 || H4 < 64 || H4 % 64 ||
      r != kRank || sa < 1 || sh < 1 || !(bm == 32 || (bm == 64 && ncs <= 6)))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies: cp.async of the weights and gy, the tiles' stores
  if (misaligned(w1) || misaligned(a1) || misaligned(bb1) ||
      misaligned(w2) || misaligned(a2) || misaligned(bb2) ||
      misaligned(gy) || misaligned(lnd) || misaligned(mbuf) ||
      misaligned(hbuf))
    return (int)cudaErrorMisalignedAddress;
  Args a;
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
  a.w2 = static_cast<const bf16*>(w2);
  a.a2 = static_cast<const bf16*>(a2);
  a.bb2 = static_cast<const bf16*>(bb2);
  a.gy = static_cast<const bf16*>(gy);
  a.dx = static_cast<bf16*>(dx);
  a.lnd = static_cast<bf16*>(lnd);
  bf16* mb = static_cast<bf16*>(mbuf);
  a.m1 = mb;
  a.dm1 = mb + (size_t)M * r;
  a.m2 = mb + 2 * (size_t)M * r;
  a.dm2 = mb + 3 * (size_t)M * r;
  a.du1 = static_cast<bf16*>(hbuf);
  a.gd = a.du1 + (size_t)M * H4;
  a.gb = static_cast<float*>(gb);
  a.H4 = H4;
  a.keep_w1 = keep_w1;
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

  const int blocks = (M + bm - 1) / bm;
  cudaError_t e = bm == 32   ? launch_rows<32, 12>(a, blocks, smem, st)
                  : ncs <= 2 ? launch_rows<64, 2>(a, blocks, smem, st)
                  : ncs <= 3 ? launch_rows<64, 3>(a, blocks, smem, st)
                             : launch_rows<64, 6>(a, blocks, smem, st);
  if (e != cudaSuccess) return (int)e;

  // dA1^T [r, C] = dm1^T bf16(drop1(ln)); dB2^T [C, r] = bf16(s2 gy)^T m2;
  // dB1^T [4C, r] = du1^T m1; dA2^T [r, 4C] = dm2^T bf16(drop2(g))
  float* pp = static_cast<float*>(part);
  float* dhp = static_cast<float*>(dh);
  const MatSrc lnds{a.lnd, C, 1.f, 0}, du2{a.gy, C, s2, 1};
  const MatSrc m1s{a.m1, r, 1.f, 0}, dm1s{a.dm1, r, 1.f, 0};
  const MatSrc m2s{a.m2, r, 1.f, 0}, dm2s{a.dm2, r, 1.f, 0};
  const MatSrc du1s{a.du1, H4, 1.f, 0}, gds{a.gd, H4, 1.f, 0};
  e = wgrad(dm1s, lnds, M, r, C, sa, pp, static_cast<float*>(da1), st);
  if (e != cudaSuccess) return (int)e;
  e = wgrad(du2, m2s, M, C, r, sa, pp, static_cast<float*>(dbb2), st);
  if (e != cudaSuccess) return (int)e;
  e = wgrad(du1s, m1s, M, H4, r, sh, pp, dhp, st);
  if (e != cudaSuccess) return (int)e;
  e = wgrad(dm2s, gds, M, r, H4, sh, pp, dhp + (size_t)H4 * r, st);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_parts(a.gb, blocks * (bm / kRows), 2 * (size_t)C,
                        static_cast<float*>(dgb), st);
}
