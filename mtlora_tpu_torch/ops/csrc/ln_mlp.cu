// Fused LayerNorm + whole MLP with shared LoRA on both layers (forward)
// for Hopper:
//   ln = LN(x)                                     fp32 statistics
//   h  = bf16(ln) W1^T + b1 + s1 bf16(bf16(drop1(ln)) A1^T) B1^T
//   g  = gelu(h)                                   tanh form, fp32
//   y  = bf16(bf16(g) W2^T + b2 + s2 bf16(bf16(drop2(g)) A2^T) B2^T)
//
// Replaces mtlora_tpu/ops/pallas_ln_mlp.py: _fwd_kernel (:54), launched by
// _run_fwd (:250, call :256) through fused_ln_mlp (:217), the MLP of the
// blocks with no task streams. The GELU is the TPU kernel's bf16 form,
// the tanh form (lnk::kGelu); the port's unfused MLP keeps F.gelu's exact
// erf, as the JAX package's jnp path does.
//
// What bounds it: per row 2 * 2 * C * 4C FLOP of frozen products (+ the
// rank-64 adapters, 40% of the work at C = 96) for 4C bytes of x and y:
// far above the card's ridge, so the tensor cores bound it (chip_smoke.py
// prints the bound). The TPU kernel's win, kept here, is that the [M, 4C]
// hidden (308 MB in bf16 at batch 32) never reaches device memory. What
// held the first port back was the weights: read from device memory
// inside the MMA loop, once per 16 rows, every MMA waiting on its load.
// On this card the limits are now issue and latency: one block of 8 warps
// an SM (255 registers a thread), the GELU and the dropout hash between
// the products, and at C = 768 the L2 bytes of the weight boxes. Design:
//   - a block of 8 warps owns BM rows: WN warps share 16 rows and split
//     their y columns (CW = C / WN each, at most 192, so that the warp's
//     y tile, 16 x CW fp32, stays in registers): WN = 1 and BM = 128 at
//     C <= 192, WN = 2 and BM = 64 at C = 256 and 384, WN = 4 and BM = 32
//     at C = 512 and 768 (the launch plan, ops/ln_mlp.py:fwd_plan, owns
//     rows, ring depth, shared-memory bytes and blocks; the kernel traps
//     if the bytes do not hold its layout); the last block masks its rows
//     past M;
//   - x is copied once by cp.async; the LayerNorm statistics, the A
//     fragments of bf16(drop1(ln)) for m1 (no second tile) and then
//     bf16(ln) in x's place come from shared memory; bf16(ln) stays
//     resident, m1 stays in registers as the A fragments of the B1
//     products;
//   - every weight streams through a ring of kStages [64 x 64] slots by
//     TMA (one thread starts a group's boxes, 128-byte swizzle, zero
//     outside the arrays, one mbarrier a group), kGroup slots a barrier,
//     kStages - kGroup ahead: A1 (m1); per super-chunk of WN x 64 hidden
//     columns B1 (u), W1 (h), A2 (m2), W2 (y); B2 (the epilogue). Every
//     weight is read in its module layout, no transposed copy; each staged
//     byte serves BM rows, 2 to 8 times the 16 of the first port;
//   - warp (mi, ni) makes h for its 64 hidden columns of the super-chunk
//     (h starts at s1 u, then the W1 products, then b1), GELU and the
//     dropout mask in registers, and repacks the accumulators as the A
//     fragments of bf16(g) and bf16(drop2(g)) (two n8 tiles are one k16
//     fragment, FA-2's layout): m2 accumulates in registers from them.
//     With WN = 1 the y products take bf16(g) from the same registers: no
//     shared memory, no barrier. With WN > 1 the warps of a row group
//     exchange bf16(g) through a double-buffered shared tile, meeting at
//     a named barrier of their WN warps alone, and sum their m2 shares in
//     a fixed order at the end;
//   - the products: mma.sync m16n8k16, B fragments by ldmatrix from the
//     swizzled slots. MMAs a warp issues between two ring barriers: a
//     slot it multiplies with is 32 (16 rows x 64 x 64), and a group of
//     kGroup = 8 slots holds 8 / WN of its slots: 256 at WN = 1 (fewer
//     where C = 96 leaves half slots), 128 at WN = 2, 64 at WN = 4.

#include "slice_ring.cuh"
#include "tma.cuh"

namespace {

using namespace lnk;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 64;               // a slice, and a warp's hidden chunk
constexpr int kStages = 16;          // slices in the TMA ring
constexpr int kGroup = 8;            // slices a barrier
constexpr int kRank = 64;
constexpr int kLdS = kS + 8;         // row stride of the m1 tile
constexpr int kSlice = kS * kS;      // elements of a ring slot
constexpr int kNB = kStages / kGroup;  // groups in the ring, one mbarrier each
static_assert(kStages % kGroup == 0 && kNB >= 2, "kStages - kGroup ahead");
static_assert(kS == kSliceW, "slice_ring.cuh: a_frags, ksteps");

// The weights as TMA tensor maps: [rows][cols] bf16, boxes of 64 x 64
// stored with the 128-byte swizzle (zero outside the array).
enum { kW1, kA1, kB1, kW2, kA2, kB2, kMaps };
struct Maps {
  CUtensorMap m[kMaps];
};

struct Args {
  Rows R;  // x [M, C]
  const bf16 *gamma, *beta, *w1, *bias1, *a1, *bb1, *w2, *bias2, *a2, *bb2;
  bf16* y;
  int H4;
  float s1, s2;
  DropSpec d1, d2;
};

// An instance: warps of CW y columns, WN of them on the same rows.
template <int CW, int WN>
struct Walk {
  static_assert(WN == 1 || CW % kS == 0, "whole W2 slices a warp");
  static constexpr int C = CW * WN;
  static constexpr int NL = (CW + kS - 1) / kS;  // W2, B2 row slices a warp
  static constexpr int NCS = WN * NL;            // 64-column slices of C
  static constexpr int PER = 2 * WN * (NCS + 1); // slices a super-chunk
  Args a;
  Maps maps;
};

// A slice: the box of tensor map `map` at column c0, row r0.
struct Box {
  int map, c0, r0;
};

// The q-th slice a block multiplies with: A1 (NCS); per super-chunk j
// of WN x 64 hidden columns from hs, B1 and A2 of warp column i, W1 by
// (column slice, i), W2 by (hidden part k, row slice c of warp column
// w); then B2 by (c, w). Within each run, WN consecutive slices are one
// for each warp column.
template <int CW, int WN>
__device__ __forceinline__ Box box_of(const Walk<CW, WN>& p, int q) {
  using W = Walk<CW, WN>;
  constexpr int NCS = W::NCS, NL = W::NL, PER = W::PER;
  const int nsc = p.a.H4 / (kS * WN);
  if (q < NCS) return Box{kA1, kS * q, 0};                           // m1
  q -= NCS;
  const int j = q / PER;
  if (j < nsc) {
    const int hs = kS * WN * j;
    int i = q - j * PER;
    if (i < WN) return Box{kB1, 0, hs + kS * i};                     // u
    i -= WN;
    if (i < WN * NCS) return Box{kW1, kS * (i / WN), hs + kS * (i % WN)};
    i -= WN * NCS;
    if (i < WN) return Box{kA2, hs + kS * i, 0};                     // m2
    i -= WN;
    const int w = i % WN, c = (i / WN) % NL, k = i / (WN * NL);      // y
    return Box{kW2, hs + kS * k, kS * (w * NL + c)};
  }
  q -= nsc * PER;
  return Box{kB2, 0, kS * ((q % WN) * NL + q / WN)};
}

// The ring of weight slices of a block: kStages slots in kNB groups of
// kGroup, one mbarrier a group. Thread 0 starts a group's kGroup TMA
// boxes; every thread calls next() at the same points, and slice q is
// resident when next() returns it. Where q starts a group, next() waits
// on that group's mbarrier, meets the block at a barrier, and thread 0
// starts the group kNB - 1 ahead into the slots of the group before,
// free because every thread passed that barrier after its products on
// them.
template <class P>
struct TmaRing {
  bf16* buf;       // 1024-byte aligned
  uint64_t* bars;  // kNB
  int q, total;

  __device__ __forceinline__ void issue(const P& p, int g) {
    const int first = g * kGroup, n = min(kGroup, total - first);
    if (threadIdx.x != 0 || n <= 0) return;
    uint64_t* bar = bars + g % kNB;
    mbar_expect(bar, n * kSlice * (int)sizeof(bf16));
    for (int k = 0; k < n; ++k) {
      const Box b = box_of(p, first + k);
      tma_box(buf + ((first + k) % kStages) * kSlice, &p.maps.m[b.map], bar,
              b.c0, b.r0);
    }
  }

  __device__ __forceinline__ void start(const P& p) {
    if (threadIdx.x == 0)
      for (int g = 0; g < kNB; ++g) mbar_init(bars + g);
    for (int g = 0; g < kNB - 1; ++g) issue(p, g);
  }

  __device__ __forceinline__ const bf16* next(const P& p) {
    if (q % kGroup == 0) {
      const int g = q / kGroup;
      mbar_wait(bars + g % kNB, (g / kNB) & 1);
      __syncthreads();
      issue(p, g + kNB - 1);
    }
    return buf + (q++ % kStages) * kSlice;
  }
};

// Barrier of the `threads` threads that name barrier `id` (the warps of
// one row group).
__device__ __forceinline__ void rows_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Mean and 1/sqrt(var + eps) of the block's BM rows of x, staged in
// `xt` (row stride ld), in fp32 as rows_stats computes them: kThreads / BM
// threads a row, each summing a run of its columns, then a shuffle sum;
// rows past M get 0 and 0.
template <int BM>
__device__ __forceinline__ void tile_stats(const bf16* xt, int ld, int C,
                                           int m0, int M, float* mu,
                                           float* inv) {
  constexpr int kPer = kThreads / BM;  // threads a row: 2, 4 or 8
  const int i = threadIdx.x / kPer, part = threadIdx.x % kPer;
  const int run = C / kPer;            // a multiple of 4
  const bf16* p = xt + i * ld + part * run;
  float s = 0.f, q = 0.f;
  for (int k = 0; k < run; k += 2) {
    const float2 v = bf2(p + k);
    s += v.x + v.y;
    q += v.x * v.x + v.y * v.y;
  }
#pragma unroll
  for (int o = 1; o < kPer; o <<= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    q += __shfl_xor_sync(0xffffffffu, q, o);
  }
  if (part == 0) {
    const float mean = s / C;
    const bool in = m0 + i < M;
    mu[i] = in ? mean : 0.f;
    inv[i] = in ? rsqrtf(q / C - mean * mean + kEps) : 0.f;
  }
}

// A fragments of bf16(drop1(ln)) for the warp's 16 rows from r0 (of the
// block, whose first is row m0) and the 16 ks columns from c0, from x
// staged in `xt` (row stride ld) and the rows' statistics (zero past M).
__device__ __forceinline__ void lnd_frags(uint32_t (*af)[4], const Args& a,
                                          const bf16* xt, int ld, int m0,
                                          int r0, int c0, int ks,
                                          const float* mu, const float* inv,
                                          const Drop& d) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < kS / 16; ++k)
    if (k < ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = r0 + g + 8 * (e & 1), m = m0 + i;
        const int c = c0 + 16 * k + 2 * t + 8 * (e >> 1);
        float v0 = 0.f, v1 = 0.f;
        if (m < a.R.M) {
          const float2 v = bf2(xt + i * ld + c), gm = bf2(a.gamma + c),
                       be = bf2(a.beta + c);
          v0 = d.apply(ln_val(v.x, mu[i], inv[i], gm.x, be.x), m, a.R.K, c);
          v1 = d.apply(ln_val(v.y, mu[i], inv[i], gm.y, be.y), m, a.R.K,
                       c + 1);
        }
        af[k][e] = pack_bf2(v0, v1);
      }
}

// The bf16 A fragments of a warp's 16 x 64 accumulator tiles.
__device__ __forceinline__ void pack_frags(uint32_t (*af)[4],
                                           const float (*c)[4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    af[nt >> 1][2 * (nt & 1)] = pack_bf2(c[nt][0], c[nt][1]);
    af[nt >> 1][2 * (nt & 1) + 1] = pack_bf2(c[nt][2], c[nt][3]);
  }
}

// y = bf16((y + b2) + s2 u2) for the warp's 16 rows from r0 and the NT
// n-tiles from column c0.
template <int NT>
__device__ __forceinline__ void y_out(const Args& a, const float (*yc)[4],
                                      const float (*u2)[4], int c0, int r0) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = c0 + 8 * nt + 2 * t;
    const float2 b = bf2(a.bias2 + c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = r0 + g + 8 * half;
      if (m < a.R.M)
        st_bf2(a.y + (size_t)m * a.R.K + c,
               (yc[nt][2 * half] + b.x) + a.s2 * u2[nt][2 * half],
               (yc[nt][2 * half + 1] + b.y) + a.s2 * u2[nt][2 * half + 1]);
    }
  }
}

template <int CW, int WN>
__global__ void __launch_bounds__(kThreads, 1)
    ln_mlp_fwd_kernel(const __grid_constant__ Walk<CW, WN> p) {
  using W = Walk<CW, WN>;
  constexpr int C = W::C, NCS = W::NCS;
  constexpr int WM = kWarps / WN, BM = kRows * WM;
  constexpr int LD = C + 8;           // row stride of the LN tile
  constexpr int LG = WN * kS + 8;     // row stride of the g tiles
  constexpr int YT = CW / 8;          // y n-tiles of a warp
  constexpr int NR = kRank / 8 / WN;  // m1 n-tiles of a warp
  constexpr int YF = CW / kS;         // whole W2 slices of a warp
  extern __shared__ __align__(1024) unsigned char smem[];
  const Args& a = p.a;
  const int M = a.R.M, H4 = a.H4, nsc = H4 / (kS * WN);
  const int warp = threadIdx.x >> 5, lane = lane_id(), g = lane >> 2,
            t = lane & 3;
  const int mi = warp / WN, ni = warp % WN, wr = kRows * mi;
  const int m0 = blockIdx.x * BM;
  // Dynamic shared memory, from its first 1024-byte boundary (the
  // swizzle's period): the ring, the bf16(ln) tile [BM][C + 8]; where
  // WN > 1 the m1 tile [BM][72] and each row group's two g tiles
  // [WM][2][16][LG] (bf16; at the end its m2 shares, [WN][1024] fp32);
  // mu, inv [BM] (fp32); the ring's mbarriers. The padded strides keep
  // ldmatrix free of bank conflicts.
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  bf16* lt = reinterpret_cast<bf16*>(base) + kStages * kSlice;
  bf16* m1t = lt + BM * LD;
  bf16* gt = m1t + (WN > 1 ? BM * kLdS : 0);
  float* mu = reinterpret_cast<float*>(gt + (WN > 1 ? 2 * BM * LG : 0));
  float* inv = mu + BM;
  TmaRing<W> ring{reinterpret_cast<bf16*>(base),
                  reinterpret_cast<uint64_t*>(inv + BM), 0,
                  2 * NCS + nsc * W::PER};
  // the plan's bytes (ops/ln_mlp.py:fwd_plan) must hold this layout
  if (reinterpret_cast<unsigned char*>(ring.bars + kNB) - smem >
      dynamic_smem_bytes())
    __trap();

  // x into the LN tile's place (zero past M) by cp.async, while the ring's
  // first groups stream in
  for (int v = threadIdx.x; v < BM * (C / 8); v += kThreads) {
    const int i = v / (C / 8), c = 8 * (v - i * (C / 8));
    const bool in = m0 + i < M;
    cp_async16(lt + i * LD + c, in ? a.R.x + (size_t)(m0 + i) * C + c : a.R.x,
               in);
  }
  cp_async_commit();
  ring.start(p);
  cp_async_wait<0>();
  __syncthreads();
  tile_stats<BM>(lt, LD, C, m0, M, mu, inv);
  __syncthreads();
  const Drop d1 = make_drop(a.d1), d2 = make_drop(a.d2);

  // ---- m1 = bf16(bf16(drop1(ln)) A1^T): warp ni makes its NR n-tiles --
  uint32_t m1f[4][4];
  {
    float acc[NR][4];
    zero<NR>(acc);
#pragma unroll 1
    for (int cs = 0; cs < NCS; ++cs) {
      const bf16* sl = ring.next(p);
      const int ks = ksteps(C, cs);
      uint32_t af[4][4];
      lnd_frags(af, a, lt, LD, m0, wr, kS * cs, ks, mu, inv, d1);
      mma_slot<NR>(acc, af, sl, NR * 8 * ni, ks);
    }
    if constexpr (WN > 1) store_tile<NR>(m1t + wr * kLdS, kLdS, acc,
                                         NR * 8 * ni);
    // x is read: bf16(ln) in its place
    __syncthreads();
    for (int v = threadIdx.x; v < BM * (C / 2); v += kThreads) {
      const int i = v / (C / 2), c = 2 * (v - i * (C / 2));
      const float2 x2 = bf2(lt + i * LD + c), gm = bf2(a.gamma + c),
                   be = bf2(a.beta + c);
      const bool in = m0 + i < M;
      st_bf2(lt + i * LD + c,
             in ? ln_val(x2.x, mu[i], inv[i], gm.x, be.x) : 0.f,
             in ? ln_val(x2.y, mu[i], inv[i], gm.y, be.y) : 0.f);
    }
    __syncthreads();
    if constexpr (WN == 1)
      pack_frags(m1f, acc);
    else
      a_frags(m1f, m1t + wr * kLdS, kLdS, 4);
  }

  // ---- the hidden in super-chunks of WN x 64 columns ----------------------
  float y[YT][4], m2[8][4];
  zero<YT>(y);
  zero<8>(m2);
#pragma unroll 1
  for (int j = 0; j < nsc; ++j) {
    const int h0 = kS * (WN * j + ni);
    // h = s1 m1 B1^T + bf16(ln) W1^T for the warp's 64 columns
    float hc[8][4];
    zero<8>(hc);
#pragma unroll
    for (int i = 0; i < WN; ++i) {
      const bf16* sl = ring.next(p);
      if (i == ni) mma_slot<8>(hc, m1f, sl, 0, 4);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hc[nt][e] *= a.s1;
#pragma unroll 1
    for (int cs = 0; cs < NCS; ++cs)
#pragma unroll
      for (int i = 0; i < WN; ++i) {
        const bf16* sl = ring.next(p);
        if (i == ni) {
          const int ks = ksteps(C, cs);
          uint32_t af[4][4];
          a_frags(af, lt + wr * LD + kS * cs, LD, ks);
          mma_slot<8>(hc, af, sl, 0, ks);
        }
      }
    // g = gelu(h + b1), bf16(g) and bf16(drop2(g)) as A fragments
    uint32_t gf[4][4], gdf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = h0 + 8 * nt + 2 * t;
      const float2 b = bf2(a.bias1 + col);
      float gl[4], gd[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gl[e] = act_fwd<kGelu>(hc[nt][e] + ((e & 1) ? b.y : b.x));
        gd[e] = d2.apply(gl[e], m0 + wr + g + 8 * (e >> 1), H4, col + (e & 1));
      }
      gf[nt >> 1][2 * (nt & 1)] = pack_bf2(gl[0], gl[1]);
      gf[nt >> 1][2 * (nt & 1) + 1] = pack_bf2(gl[2], gl[3]);
      gdf[nt >> 1][2 * (nt & 1)] = pack_bf2(gd[0], gd[1]);
      gdf[nt >> 1][2 * (nt & 1) + 1] = pack_bf2(gd[2], gd[3]);
    }
    // m2 += bf16(drop2(g)) A2^T
#pragma unroll
    for (int i = 0; i < WN; ++i) {
      const bf16* sl = ring.next(p);
      if (i == ni) mma_slot<8>(m2, gdf, sl, 0, 4);
    }
    // y += bf16(g) W2^T over the super-chunk
    bf16* gb = gt + (2 * mi + (j & 1)) * kRows * LG;
    if constexpr (WN > 1) {
      bf16* gp = gb + g * LG + kS * ni + 2 * t;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        *reinterpret_cast<uint32_t*>(gp + 16 * k) = gf[k][0];
        *reinterpret_cast<uint32_t*>(gp + 8 * LG + 16 * k) = gf[k][1];
        *reinterpret_cast<uint32_t*>(gp + 16 * k + 8) = gf[k][2];
        *reinterpret_cast<uint32_t*>(gp + 8 * LG + 16 * k + 8) = gf[k][3];
      }
      rows_bar(1 + mi, 32 * WN);
    }
#pragma unroll
    for (int k = 0; k < WN; ++k) {
      uint32_t af[4][4];
      if constexpr (WN == 1) {
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) af[s][e] = gf[s][e];
      } else {
        a_frags(af, gb + kS * k, LG, 4);
      }
#pragma unroll
      for (int c = 0; c < YF; ++c)
#pragma unroll
        for (int w = 0; w < WN; ++w) {
          const bf16* sl = ring.next(p);
          if (w == ni) mma_slot<8>(y + 8 * c, af, sl, 0, 4);
        }
      if constexpr (CW % kS != 0)
        mma_slot<4>(y + 8 * YF, af, ring.next(p), 0, 4);
    }
  }

  // ---- m2 = bf16(the row group's shares summed in order); the epilogue ---
  uint32_t m2f[4][4];
  if constexpr (WN == 1) {
    pack_frags(m2f, m2);
  } else {
    float* part = reinterpret_cast<float*>(gt + 2 * mi * kRows * LG);
    rows_bar(1 + mi, 32 * WN);  // the row group's g tiles are read
    store_frag(part + ni * 1024 + lane * 4, m2);
    rows_bar(1 + mi, 32 * WN);
    zero<8>(m2);
#pragma unroll
    for (int w = 0; w < WN; ++w) {
      float sh[8][4];
      load_frag(sh, part + w * 1024 + lane * 4);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) m2[nt][e] += sh[nt][e];
    }
    pack_frags(m2f, m2);
  }
#pragma unroll
  for (int c = 0; c < YF; ++c)
#pragma unroll
    for (int w = 0; w < WN; ++w) {
      const bf16* sl = ring.next(p);
      if (w == ni) {
        float u2[8][4];
        zero<8>(u2);
        mma_slot<8>(u2, m2f, sl, 0, 4);
        y_out<8>(a, y + 8 * c, u2, CW * ni + kS * c, m0 + wr);
      }
    }
  if constexpr (CW % kS != 0) {
    float u2[4][4];
    zero<4>(u2);
    mma_slot<4>(u2, m2f, ring.next(p), 0, 4);
    y_out<4>(a, y + 8 * YF, u2, kS * YF, m0 + wr);
  }
}

template <int CW, int WN>
cudaError_t launch(const Args& a, const Maps& maps, int blocks, int smem,
                   cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      ln_mlp_fwd_kernel<CW, WN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  ln_mlp_fwd_kernel<CW, WN><<<blocks, kThreads, smem, st>>>(
      Walk<CW, WN>{a, maps});
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// x [M, C] -> y [M, C]. Weights in nn.Linear layouts: w1 [4C, C],
// a1 [r, C], bb1 [4C, r], w2 [C, 4C], a2 [r, 4C], bb2 [C, r]; bf16 biases.
// bm (128 where C <= 192, 64 where C <= 384, else 32) and the shared-memory
// bytes smem are the caller's launch plan (ops/ln_mlp.py:fwd_plan); the
// kernel traps if smem does not hold its layout. C is 96, 128, 192, 256,
// 384, 512 or 768 (a warp's CW = C / WN columns are 96, 128 or 192).
extern "C" int mtlora_ln_mlp_fwd(const void* x, const void* gamma,
                                 const void* beta, const void* w1,
                                 const void* bias1, const void* a1,
                                 const void* bb1, const void* w2,
                                 const void* bias2, const void* a2,
                                 const void* bb2, const void* seed, void* y,
                                 int M, int C, int H4, int r, int bm,
                                 int smem, float s1, float s2, unsigned thr,
                                 int use_drop, float inv_keep, void* stream) {
  const int wn = C <= 192 ? 1 : C <= 384 ? 2 : 4, cw = C / wn;
  if (M < 1 || r != kRank || C % wn || !(cw == 96 || cw == 128 || cw == 192) ||
      H4 < kS * wn || H4 % (kS * wn) || bm != kRows * kWarps / wn)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of x, TMA boxes of the weights
  if (misaligned(x) || misaligned(w1) || misaligned(a1) || misaligned(bb1) ||
      misaligned(w2) || misaligned(a2) || misaligned(bb2))
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
  a.bias2 = static_cast<const bf16*>(bias2);
  a.a2 = static_cast<const bf16*>(a2);
  a.bb2 = static_cast<const bf16*>(bb2);
  a.y = static_cast<bf16*>(y);
  a.H4 = H4;
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
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  Maps maps;
  if (!box_map(&maps.m[kW1], w1, H4, C) || !box_map(&maps.m[kA1], a1, r, C) ||
      !box_map(&maps.m[kB1], bb1, H4, r) || !box_map(&maps.m[kW2], w2, C, H4) ||
      !box_map(&maps.m[kA2], a2, r, H4) || !box_map(&maps.m[kB2], bb2, C, r))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (M + bm - 1) / bm;
  cudaError_t e;
  if (wn == 1)
    e = cw == 96    ? launch<96, 1>(a, maps, blocks, smem, st)
        : cw == 128 ? launch<128, 1>(a, maps, blocks, smem, st)
                    : launch<192, 1>(a, maps, blocks, smem, st);
  else if (wn == 2)
    e = cw == 128 ? launch<128, 2>(a, maps, blocks, smem, st)
                  : launch<192, 2>(a, maps, blocks, smem, st);
  else
    e = cw == 128 ? launch<128, 4>(a, maps, blocks, smem, st)
                  : launch<192, 4>(a, maps, blocks, smem, st);
  return (int)e;
}
