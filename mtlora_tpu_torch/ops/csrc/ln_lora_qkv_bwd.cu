// Fused LayerNorm + frozen GEMM + shared LoRA in y-only mode (backward)
// for Hopper, at norm1 -> qkv of every block: one row kernel, then the
// weight passes.
//
// Replaces mtlora_tpu/ops/pallas_ln_lora.py: _bwd_kernel (:124) in y-only
// mode, launched by _bwd_rule (:324, call :365), the custom VJP of
// fused_ln_lora_linear. With ln and the hash mask (stream 0) recomputed,
// the cast points of _bwd_kernel:
//   gpt = bf16(gy)                       du = bf16(s gy)
//   m   = bf16(bf16(drop0(ln)) A^T)      dm = bf16(du B)
//   dln = gpt W + drop0(dm A)
//   dB^T = du^T m                        dA^T = dm^T bf16(drop0(ln))
//   dgamma, dbeta, dx: the LayerNorm backward of dln.
//
// What bounds it: one frozen product (dln, 2 M C O FLOP) and four rank-64
// products, 2 M (C O + 3 C r + 2 O r) FLOP, against the bytes of x, gy and
// dx (2 M (2 C + O)): ~60-170 FLOP a byte, under the card's ~295 ridge, so
// the bytes bound it. What held the first port back (4 warps per 16
// rows, every block reading all of W from L2 as fragments, gy re-read per
// 64 columns of C, dln through an fp32 scratch [M, C], three transposed
// weight copies per call) is answered by the design of kernels 4 and
// 2b-tail (a cp.async ring, as 2b-tail's, was slower here than TMA):
//   - a block of 8 warps owns BM rows. Up to C = 384 two blocks share an
//     SM, so that one's LayerNorm, hashing and barriers overlap the
//     other's products: 64 rows up to C = 192, 32 above, so that dln
//     (BM x C fp32) stays at 48 registers a thread. Above, one block an
//     SM with dln at 96 registers (128 at C = 1024): 32 rows, few (1.5
//     waves at C = 768), so the two blocks of a cluster split the hidden
//     chunks, the second handing its dln and dm partials to the first
//     through device memory (the launch plan, ops/ln_lora.py:qkv_bwd_plan,
//     chooses; the kernel traps if the plan's bytes do not hold its
//     layout);
//   - its rows of x (and gamma, beta) arrive once by cp.async and stay,
//     for the statistics, bf16(drop0(ln)) (and stream 0's mask as bytes,
//     hashed once) and the LayerNorm backward;
//   - every slice it multiplies with streams through a ring of [64 x 64]
//     slots by TMA (the lanes of warp 0 start a group's boxes at once,
//     128-byte swizzle, zero outside the arrays, one mbarrier a group;
//     started one after another by one thread, the boxes held the block
//     at its barriers longer than its products took), in the module
//     layouts (wt [O, C], at [r, C], bt [O, r]; ldmatrix.trans for the
//     transposed uses; a rank r < 64 and the last hidden chunk zero-filled
//     to 64): A (m); per 64-column hidden chunk gy's tile [BM x 64], B's
//     slice, W's ceil(C / 64) slices; A (dl). The warps load their A
//     fragments of gy once a chunk (gpt = gy) and round s gy to bf16 in
//     registers for du: dm += du B, dln += gy W, each slice used once as it
//     arrives, every weight byte staged once per block;
//   - the products: mma.sync m16n8k16 on ldmatrix fragments;
//   - the row kernel writes dx, the per-block partials of dgamma and
//     dbeta, and the rows the weight products read: bf16(drop0(ln)) [M, C],
//     m and dm [M, r]. dA and dB are lnk::wgrad products (dB over gy
//     itself, rounding s gy as it stages the tiles: du is never stored);
//     fp32 partials per stripe of rows are summed in a fixed order.
//     Deterministic, no fp32 atomics.

#include "row_block.cuh"
#include "tma.cuh"

namespace {

using namespace lnk;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 64;               // a slot and a hidden chunk: 64 wide
constexpr int kLdS = kS + 8;         // row stride of the 64-wide tiles
constexpr int kSlice = kS * kS;      // elements of a slot
constexpr int kRank = 64;            // the rank's slot (r <= 64)
constexpr int kGroupMax = 4;         // slots a ring group
static_assert(kS == kSliceW, "slice_ring.cuh: a_frags, ksteps");

// The operands as TMA tensor maps: [rows][cols] bf16, boxes of 64 columns
// and 64 rows (gy's: BM rows), 128-byte swizzle.
enum { kGy, kW, kA, kB, kMaps };

struct Args {
  Rows R;  // x [M, C]
  const bf16 *gamma, *beta;
  bf16 *dx, *lnd, *m, *dm;
  float* gb;
  float* xfer;   // split 2: the second block's dln and dm partials
  int O, r, bm;
  int gy_bytes;  // bytes of gy's box
  int split2;    // 1: the two blocks of a cluster share a row block
  int per;       // slots a hidden chunk: 2 + ceil(C / 64)
  int per_mul;   // ceil(2^16 / per): q / per = q per_mul >> 16
  int stages, group;  // ring slots and slots a group
  float s;
  DropSpec d0;
};

struct Params {
  Args a;
  CUtensorMap maps[kMaps];
};

struct Box {
  int map, c0, r0;
};

// The hidden chunks of a block: nch of them from j0, all ceil(O / 64), or
// in a cluster of two the half of the block's rank.
struct Chunks {
  int j0, nch;
};

__device__ __forceinline__ Chunks chunks_of(const Args& a) {
  const int n = ((a.O + kS - 1) / kS) >> a.split2;
  return Chunks{n * (int)(blockIdx.x & a.split2), n};
}

// The q-th slot a block multiplies with (ncs slices of 64 columns of C):
// A for m; per hidden chunk gy's box, B (dm), W (dln); A for dl.
__device__ __forceinline__ Box box_of(const Args& a, int q, int ncs) {
  const Chunks ch = chunks_of(a);
  if (q < ncs) return Box{kA, kS * q, 0};                          // m
  q -= ncs;
  const int j = (q * a.per_mul) >> 16;   // q / per, exact for q < 2^16 / per
  if (j < ch.nch) {
    const int h0 = kS * (ch.j0 + j), i = q - j * a.per;
    if (i == 0)                                                    // gy
      return Box{kGy, h0, (int)(blockIdx.x >> a.split2) * a.bm};
    if (i == 1) return Box{kB, 0, h0};                             // dm
    return Box{kW, kS * (i - 2), h0};                              // dln
  }
  return Box{kA, kS * (q - ch.nch * a.per), 0};                    // dl
}

// The ring of slots of a block: a.stages slots in groups of a.group, one
// mbarrier a group. Warp 0 starts a group's TMA boxes; every thread calls
// next() at the same points, and slot q is resident when next() returns
// it. Where q starts a group, next() waits on that group's mbarrier,
// meets the block at a barrier, and warp 0 starts the group nbar - 1 ahead
// into the slots of the group before, free because every thread passed
// that barrier after its products on them.
struct Ring {
  bf16* buf;       // 1024-byte aligned
  uint64_t* bars;  // stages / group
  int total, ncs, nbar;
  int g = 0, qg = 0, slot = 0;   // group, slot in the group, ring slot

  // Lane k of warp 0 starts box k of group gi, all at once (from one
  // thread, each box's start waited on the ones before and held the block
  // at the next barrier), lane 0 first posting the group's bytes on its
  // mbarrier.
  __device__ __forceinline__ void issue(const Params& p, int gi) {
    const Args& a = p.a;
    const int first = gi * a.group, n = min(a.group, total - first);
    if (threadIdx.x >= 32 || n <= 0) return;
    const int k = threadIdx.x;
    Box b{0, 0, 0};
    int bytes = 0;
    if (k < n) {
      b = box_of(a, first + k, ncs);
      bytes = b.map == kGy ? a.gy_bytes : kSlice * (int)sizeof(bf16);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      bytes += __shfl_xor_sync(0xffffffffu, bytes, o);
    uint64_t* bar = bars + gi % nbar;
    if (k == 0) mbar_expect(bar, bytes);
    __syncwarp();
    if (k < n)
      tma_box(buf + ((first + k) % a.stages) * kSlice, &p.maps[b.map], bar,
              b.c0, b.r0);
  }

  __device__ __forceinline__ void start(const Params& p) {
    if (threadIdx.x == 0)
      for (int k = 0; k < nbar; ++k) mbar_init(bars + k);
    for (int k = 0; k < nbar - 1; ++k) issue(p, k);
  }

  __device__ __forceinline__ const bf16* next(const Params& p) {
    if (qg == 0) {
      mbar_wait(bars + g % nbar, (g / nbar) & 1);
      __syncthreads();
      issue(p, g + nbar - 1);
    }
    const bf16* sl = buf + slot * kSlice;
    if (++slot == p.a.stages) slot = 0;
    if (++qg == p.a.group) {
      qg = 0;
      ++g;
    }
    return sl;
  }
};

// A block of BM rows (64 or 32) whose dln covers at most NCS slices
// of 64 columns. Where BM * NCS <= 192 (dln at 48 registers a thread at
// most) two blocks share an SM.
template <int BM, int NCS>
__global__ void __launch_bounds__(kThreads, BM * NCS <= 192 ? 2 : 1)
    ln_lora_qkv_bwd_rows(const __grid_constant__ Params p) {
  constexpr int WM = BM / 16, WN = kWarps / WM;
  constexpr int NT = kS / 8 / WN;   // n-tiles of a warp in a 64-wide product
  extern __shared__ __align__(1024) unsigned char smem[];
  const Args& a = p.a;
  const int C = a.R.K, M = a.R.M, O = a.O, ld = C + 8;
  const int ncs = (C + kS - 1) / kS;
  const Chunks ch = chunks_of(a);
  const int rank = blockIdx.x & a.split2;
  const int warp = threadIdx.x >> 5, lane = lane_id(), g = lane >> 2,
            t = lane & 3;
  const int mi = warp % WM, ni = warp / WM;
  const int wr = kRows * mi, wc = 8 * NT * ni;   // the warp's rows, columns
  const int m0 = (blockIdx.x >> a.split2) * BM;
  // Dynamic shared memory, from its first 1024-byte boundary (the
  // swizzle's period): the ring; the bf16(drop0(ln)) tile [BM][C + 8], the
  // m / dm tile [BM][72], the block's rows of x [BM][C + 8], gamma and
  // beta [C] (bf16); mu, inv [BM] and the row sums of the LayerNorm
  // backward [2][WN][BM] (fp32); the ring's mbarriers; stream 0's mask
  // over the block's ln [BM][C], 1 where kept. The padded row strides keep
  // ldmatrix free of bank conflicts.
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  bf16* lt = reinterpret_cast<bf16*>(base) + a.stages * kSlice;
  bf16* mt = lt + BM * ld;
  bf16* xt = mt + BM * kLdS;
  bf16* gs = xt + BM * ld;
  bf16* bs = gs + C;
  float* mu = reinterpret_cast<float*>(bs + C);
  float* inv = mu + BM;
  float* red = inv + BM;
  // the second block of a cluster takes no dl slots
  Ring ring{reinterpret_cast<bf16*>(base),
            reinterpret_cast<uint64_t*>(red + 2 * WN * BM),
            (2 - rank) * ncs + ch.nch * a.per, ncs, a.stages / a.group};
  uint8_t* kb = reinterpret_cast<uint8_t*>(ring.bars + ring.nbar);
  // the plan's bytes (ops/ln_lora.py:qkv_bwd_plan) must hold this layout
  if (kb + BM * C - smem > dynamic_smem_bytes() || a.group > kGroupMax ||
      ring.nbar < 2)
    __trap();

  // The block's rows of x, gamma and beta by cp.async, while the ring's
  // first groups stream in
  x_in<BM, kThreads>(xt, ld, a.R, m0);
  for (int v = threadIdx.x; v < C / 8; v += kThreads) {
    cp_async16(gs + 8 * v, a.gamma + 8 * v, true);
    cp_async16(bs + 8 * v, a.beta + 8 * v, true);
  }
  cp_async_commit();
  ring.start(p);
  cp_async_wait<0>();
  __syncthreads();
  const TileRows xs{xt, M, C, ld, m0};
  for (int i = 0; i < BM; i += kRows)
    rows_stats(xs, m0 + i, mu + i, inv + i, warp, kWarps);
  __syncthreads();
  const Drop d0 = make_drop(a.d0);
  // bf16(drop0(ln)), as rows_ln_tile computes it, and the mask's bytes
  // for dl (hashed once)
  for (int i = warp; i < BM; i += kWarps) {
    const int m = m0 + i;
    for (int k = 2 * lane; k < C; k += 64) {
      float v0 = 0.f, v1 = 0.f;
      bool k0 = true, k1 = true;
      if (m < M) {
        const float2 xv = xs.pair(m, k), gm = bf2(gs + k), be = bf2(bs + k);
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
    for (int cs = 0; cs < ncs; ++cs) {
      const bf16* sl = ring.next(p);   // meets the block: lt is whole
      const int ks = ksteps(C, cs);
      uint32_t af[kS / 16][4];
      a_frags(af, lt + wr * ld + kS * cs, ld, ks);
      mma_slot<NT>(acc, af, sl, wc, ks);
    }
    store_tile<NT>(mt + wr * kLdS, kLdS, acc, wc);
  }
  if (rank == 0) rows_out<kThreads>(a.lnd, C, 0, lt, ld, m0, M, BM, C);
  __syncthreads();
  if (rank == 0) rows_out<kThreads>(a.m, a.r, 0, mt, kLdS, m0, M, BM, a.r);

  // ---- the hidden in chunks of 64 columns ---------------------------------
  float dln[NCS][NT][4], dma[NT][4];
#pragma unroll
  for (int cs = 0; cs < NCS; ++cs) zero<NT>(dln[cs]);
  zero<NT>(dma);
  for (int j = 0; j < ch.nch; ++j) {
    const int ks = ksteps(O, ch.j0 + j);
    // gy's A fragments of the warp's rows (gpt = gy), once a chunk
    uint32_t af[kS / 16][4];
    a_frags_slot(af, ring.next(p), wr, ks);
    // dm += bf16(s gy) B
    {
      const bf16* sl = ring.next(p);
      uint32_t du[kS / 16][4];
#pragma unroll
      for (int k = 0; k < kS / 16; ++k)
        if (k < ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) du[k][e] = scale_pair(af[k][e], a.s);
      mma_slot_t<NT>(dma, du, sl, wc, ks);
    }
    // dln += gy W, slice by slice as they arrive
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs)
      if (cs < ncs) {
        const bf16* sl = ring.next(p);
        if (kS * cs + wc < C) mma_slot_t<NT>(dln[cs], af, sl, wc, ks);
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
    if (rank == 1) return;   // its ring took its last slot
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs)
      if (cs < ncs)
#pragma unroll
        for (int v = 0; v < NT * 4; ++v)
          dln[cs][v / 4][v % 4] += xf[(cs * NT * 4 + v) * kThreads];
#pragma unroll
    for (int v = 0; v < NT * 4; ++v) dma[v / 4][v % 4] += xm[v * kThreads];
  }

  // ---- dm to its rows and over m; dln += drop0(bf16(dm) A) ---------------
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
  __syncthreads();   // the dm tile is whole
  {
    uint32_t af[kS / 16][4];
    a_frags(af, mt + wr * kLdS, kLdS, 4);
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs)
      if (cs < ncs) {
        const bf16* sl = ring.next(p);
        if (kS * cs + wc < C) {
          float dl[NT][4];
          zero<NT>(dl);
          mma_slot_t<NT>(dl, af, sl, wc, 4);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint16_t kk = *reinterpret_cast<const uint16_t*>(
                  kb + (wr + g + 8 * h) * C + kS * cs + wc + 8 * nt + 2 * t);
              const float ik = d0.on ? d0.inv_keep : 1.f;
              dln[cs][nt][2 * h] += (kk & 1) ? dl[nt][2 * h] * ik : 0.f;
              dln[cs][nt][2 * h + 1] +=
                  (kk >> 8) ? dl[nt][2 * h + 1] * ik : 0.f;
            }
        }
      }
  }

  // ---- LayerNorm backward: dx; the 16-row partials of dgamma and dbeta
  // into the ring's slots [WM][2][C] (past the last slot's products), then
  // their sum over the block's rows
  __syncthreads();
  float* gbs = reinterpret_cast<float*>(ring.buf);
  ln_bwd_rows<BM, NCS, NT, WN>(dln, xs, gs, mu, inv, red,
                               gbs + mi * 2 * C, a.dx, m0, mi, ni, ncs);
  for (int c = threadIdx.x; c < 2 * C; c += kThreads) {
    float v = 0.f;
    for (int w = 0; w < WM; ++w) v += gbs[w * 2 * C + c];
    a.gb[(size_t)(m0 / BM) * 2 * C + c] = v;
  }
}

// blocks row blocks of one block each, or two (a cluster) with split2
template <int BM, int NCS>
cudaError_t launch_rows(const Params& p, int blocks, int smem,
                        cudaStream_t st) {
  auto kern = ln_lora_qkv_bwd_rows<BM, NCS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (!p.a.split2) {
    kern<<<blocks, kThreads, smem, st>>>(p);
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
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// Layouts: the forward's (wt [O, C], at [r, C], bt [O, r]), read in place
// by TMA; gy [M, O]. bm (64 up to C = 192, else 32; an instance's launch
// bounds give two blocks an SM where bm times its slices of C is at most
// 192), split (the blocks of a cluster that share a row block's hidden
// chunks: 2 where bm = 32, the block alone on its SM, and the chunks pair
// up, or 1), the ring's stages and group, and the row kernel's
// shared-memory bytes smem are the caller's launch plan
// (ops/ln_lora.py:qkv_bwd_plan); the kernel traps if smem does not hold
// its layout. Scratch: lnd [M, C], mbuf [2, M, r] (m, dm) bf16;
// gb [ceil(M / bm), 2, C], the weight-gradient partials part (sa stripes
// of [r, C], then sb of [O, r]) and, with split 2, xfer [ceil(M / bm),
// (ceil(C / 64) + 1) 8, 256] fp32. Outputs: dx; dgb [2, C], dat [r, C],
// dbt [O, r] (fp32).
// use_drop: hash stream 0 at threshold thr.
extern "C" int mtlora_ln_lora_qkv_bwd(
    const void* x, const void* gamma, const void* beta, const void* wt,
    const void* at, const void* bt, const void* seed, const void* gy,
    void* dx, void* lnd, void* mbuf, void* gb, void* part, void* xfer,
    void* dgb, void* dat, void* dbt, int M, int C, int O, int r, int bm,
    int split, int stages, int group, int smem, int sa, int sb, float scale,
    unsigned thr, int use_drop, float inv_keep, void* stream) {
  const int ncs = (C + kS - 1) / kS, nch = (O + kS - 1) / kS;
  if (M < 1 || C <= kS || C % 32 || C > 1024 || O < 16 || O % 16 ||
      r < 16 || r % 16 || r > kRank || sa < 1 || sb < 1 ||
      !(bm == 32 || (bm == 64 && ncs <= 3)) ||
      !(split == 1 || (split == 2 && bm == 32 && nch % 2 == 0 && xfer)) ||
      group < 1 || group > kGroupMax || stages % group || stages < 2 * group)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of x, gamma, beta and the tiles' stores, TMA boxes of
  // the operands
  if (misaligned(x) || misaligned(gamma) || misaligned(beta) ||
      misaligned(wt) || misaligned(at) || misaligned(bt) || misaligned(gy) ||
      misaligned(lnd) || misaligned(mbuf))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  Args& a = p.a;
  a.R.x = static_cast<const bf16*>(x);
  a.R.M = M;
  a.R.K = C;
  a.R.Cin = C;
  a.R.Wh = 0;
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.dx = static_cast<bf16*>(dx);
  a.lnd = static_cast<bf16*>(lnd);
  a.m = static_cast<bf16*>(mbuf);
  a.dm = a.m + (size_t)M * r;
  a.gb = static_cast<float*>(gb);
  a.xfer = static_cast<float*>(xfer);
  a.O = O;
  a.r = r;
  a.bm = bm;
  a.gy_bytes = bm * kS * (int)sizeof(bf16);
  a.split2 = split == 2;
  a.per = 2 + ncs;
  a.per_mul = (65536 + a.per - 1) / a.per;
  a.stages = stages;
  a.group = group;
  a.s = scale;
  a.d0.seed = static_cast<const int*>(seed);
  a.d0.stream = 0;
  a.d0.on = use_drop;
  a.d0.thr = thr;
  a.d0.inv_keep = inv_keep;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  if (!box_map(&p.maps[kGy], gy, M, O, bm) ||
      !box_map(&p.maps[kW], wt, O, C) || !box_map(&p.maps[kA], at, r, C) ||
      !box_map(&p.maps[kB], bt, O, r))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const int blocks = (M + bm - 1) / bm;
  cudaError_t e =
      bm == 64    ? (ncs <= 2 ? launch_rows<64, 2>(p, blocks, smem, st)
                              : launch_rows<64, 3>(p, blocks, smem, st))
      : ncs <= 6  ? launch_rows<32, 6>(p, blocks, smem, st)
      : ncs <= 12 ? launch_rows<32, 12>(p, blocks, smem, st)
                  : launch_rows<32, 16>(p, blocks, smem, st);
  if (e != cudaSuccess) return (int)e;

  // dA^T [r, C] = dm^T bf16(drop0(ln)); dB^T [O, r] = bf16(s gy)^T m
  float* pp = static_cast<float*>(part);
  const MatSrc lnds{a.lnd, C, 1.f, 0}, ms{a.m, r, 1.f, 0};
  const MatSrc dms{a.dm, r, 1.f, 0};
  const MatSrc dus{static_cast<const bf16*>(gy), O, scale, 1};
  e = wgrad(dms, lnds, M, r, C, sa, pp, static_cast<float*>(dat), st);
  if (e != cudaSuccess) return (int)e;
  e = wgrad(dus, ms, M, O, r, sb, pp, static_cast<float*>(dbt), st);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_parts(a.gb, blocks, 2 * (size_t)C,
                        static_cast<float*>(dgb), st);
}
