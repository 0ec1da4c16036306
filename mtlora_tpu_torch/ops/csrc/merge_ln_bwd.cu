// The fused patch merge's backward (kernel 3b) for Hopper: one row kernel,
// then the weight product.
//
// Replaces mtlora_tpu/ops/pallas_ln_lora.py: _merge_bwd_kernel (:492) with
// train_w, launched by _merge_bwd_rule (:605, call :614), the custom VJP of
// fused_merge_ln_linear. With the forward's 2x2 gather and LN recomputed,
// the cast points of the JAX kernel and fp32 accumulation:
//   gp   = bf16(gy)                      dln = gp W
//   dW^T = gp^T bf16(ln)
//   dgamma = sum dln xhat, dbeta = sum dln,
//   dx = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dln g.
// The merged rows are those of ln_common.cuh's Rows: x [.., H, W, C]
// gathered 2x2 into rows of K = 4C in the reference concat order
// k = (di + 2 dj) C + c; merged row m = (rr, j) (rr = m / Wh, j = m % Wh)
// is four runs of C, x rows (2 rr + di) 2 Wh + 2 j + dj.
//
// What bounds it: the dln product and the weight product, 4 M K O FLOP,
// against the bytes of x, gy and dx, 2 M (2 K + O): with O = K / 2 about
// 0.8 O FLOP a byte, under the card's ~295 ridge at the first merge (O =
// 192), over it at the last (O = 768). The first port (a block of 4 warps
// on 16 rows, all of W read from L2 as fragments by every block, two
// integer divisions per bf16 pair for the gather, dln through an fp32
// scratch [M, K], a transposed copy of W per call) was latency-bound at
// 0.04 of its bound. The design takes kernel 2b's (ln_lora_qkv_bwd.cu) and
// 2-tail's (ln_lora_tail_fwd.cu) levers:
//   - a block of 8 warps owns BM rows (64, or 32 where the columns are
//     many) and a share of K: the S blocks of a cluster (S = 1, 2, 4 or 8)
//     split K, each taking ks = K / S columns, so that dln (BM x ks fp32)
//     stays at 48 registers a thread (two blocks an SM; 64 at K = 2048,
//     one block an SM) while each block stages W's slices for more rows:
//     the L2 traffic of W is M / BM K O 2 bytes whatever S. The LayerNorm
//     needs only row sums over K (the statistics, then mean(dxhat) and
//     mean(dxhat xhat)): each block sums its columns, and the blocks of a
//     cluster read each other's sums through distributed shared memory,
//     in rank order, so that every block gets the same bits. The launch
//     plan (ops/ln_lora.py:merge_bwd_plan) chooses BM, S and the ring; the
//     kernel traps if the plan's bytes do not hold its layout;
//   - its rows of x arrive once by cp.async as the runs of C they are in
//     x (16-byte copies: C % 8 == 0), into the reference order, and stay:
//     the statistics, bf16(ln) and the LayerNorm backward read them there,
//     with no index arithmetic per element; dx is written over them in
//     place and leaves as the same runs, 16 bytes a store;
//   - per 64-column hidden chunk gy's tile [BM x 64] and W's ceil(ks / 64)
//     slots of the block's columns stream through a ring of 64 x 64 slots
//     by TMA (128-byte swizzle, zero outside the arrays; the lanes of one
//     warp start a group's boxes at once), W in its module layout [O, K]
//     (ldmatrix.trans for the transposed use; no copy of W per call). The
//     warps walk the ring without block barriers, the last warp done with
//     a group refilling it, as 2-tail's ring;
//   - dln += gy W: mma.sync m16n8k16 on ldmatrix fragments, gy's A
//     fragments loaded once a chunk; dln and the LayerNorm backward stay
//     in registers (no scratch [M, K]);
//   - the row kernel writes dx, the per-block partials of dgamma and dbeta
//     and bf16(ln) [M, K], the rows the weight product reads:
//     dW^T = gp^T bf16(ln) is lnk::wgrad (fp32 partials per stripe of rows,
//     summed in a fixed order), and the dgamma/dbeta partials are summed
//     the same way. Deterministic, no fp32 atomics.

#include "row_block.cuh"
#include "tma.cuh"

namespace {

using namespace lnk;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 64;               // a slot and a hidden chunk: 64 wide
constexpr int kSlice = kS * kS;      // elements of a slot
constexpr int kGroupMax = 4;         // slots a ring group
constexpr int kSplitMax = 8;         // blocks of a cluster, at most
static_assert(kS == kSliceW, "tma.cuh: swz, mma_slot_t, a_frags_slot");

// gy and W as TMA tensor maps: [rows][cols] bf16, boxes of 64 columns and
// 64 rows (gy's: BM rows), 128-byte swizzle.
enum { kGy, kW, kMaps };

struct Args {
  const bf16 *x, *gamma, *beta;
  bf16 *dx, *lnd;
  float* gb;
  int M, C, K, O, Wh;
  int bm, ks;              // rows and columns of K a block
  int split, split_log2;   // blocks of a cluster (they split K)
  int stages, group;       // ring slots and slots a group
  int gy_bytes;            // bytes of gy's box
};

struct Params {
  Args a;
  CUtensorMap maps[kMaps];
};

struct Box {
  int map, c0, r0;
};

// Element (m, k) of the merged rows in x: run q = di + 2 dj of row m.
__device__ __forceinline__ size_t x_off(const Args& a, int m, int k) {
  const int q = k / a.C, c = k - q * a.C;
  const int rr = m / a.Wh, j = m - rr * a.Wh;
  return ((size_t)(2 * rr + (q & 1)) * (2 * a.Wh) + 2 * j + (q >> 1)) *
             a.C + c;
}

// The q-th slot of a block (per slots a hidden chunk): per chunk gy's box,
// then W's slices of the block's columns.
__device__ __forceinline__ Box box_of(const Args& a, int q, int per) {
  const int j = q / per, i = q - j * per;
  if (i == 0)
    return Box{kGy, kS * j, (int)(blockIdx.x >> a.split_log2) * a.bm};
  const int kb = (int)(blockIdx.x & (a.split - 1)) * a.ks;
  return Box{kW, kb + kS * (i - 1), kS * j};
}

// The ring of slots of a block (2-tail's, ln_lora_tail_fwd.cu): a.stages
// slots in groups of a.group, one mbarrier a group that its boxes
// complete, and one count a group of the warps done with its slots. Every
// warp calls next() at the same points of its own walk, and slot q is
// resident when next() returns it. Where q starts a group, next() first
// hands back the warp's group before: the last of the kWarps warps to
// hand a group back starts the group nbar ahead into its slots, which no
// warp reads any more. Then it waits on q's group's mbarrier.
struct Ring {
  bf16* buf;       // 1024-byte aligned
  uint64_t* bars;  // stages / group
  int* held;       // stages / group: the warps' hand-backs, counted up
  int total, per, nbar;
  int g = 0, qg = 0, slot = 0;   // group, slot in the group, ring slot

  // The calling warp starts group gi: lane k box k, all at once, lane 0
  // first posting the group's bytes on its mbarrier.
  __device__ __forceinline__ void issue(const Params& p, int gi) {
    const Args& a = p.a;
    const int first = gi * a.group, n = min(a.group, total - first);
    if (n <= 0) return;
    const int k = lane_id();
    Box b{0, 0, 0};
    int bytes = 0;
    if (k < n) {
      b = box_of(a, first + k, per);
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

  // Thread 0 sets up the mbarriers and counts, warp 0 starts the first
  // nbar groups; the block meets at a barrier before the first next().
  __device__ __forceinline__ void start(const Params& p) {
    if (threadIdx.x == 0)
      for (int k = 0; k < nbar; ++k) {
        mbar_init(bars + k);
        held[k] = 0;
      }
    if (threadIdx.x < 32)
      for (int k = 0; k < nbar; ++k) issue(p, k);
  }

  // The warp is done with group gi's slots (its reads of them are
  // complete); the last warp of the kWarps starts group gi + nbar there.
  __device__ __forceinline__ void release(const Params& p, int gi) {
    __syncwarp();
    int last = 0;
    if (lane_id() == 0) {
      __threadfence_block();
      last = atomicAdd(held + gi % nbar, 1) ==
             kWarps * (gi / nbar + 1) - 1;
    }
    if (__shfl_sync(0xffffffffu, last, 0)) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(p, gi + nbar);
    }
  }

  __device__ __forceinline__ const bf16* next(const Params& p) {
    if (qg == 0) {
      if (g > 0) release(p, g - 1);
      mbar_wait(bars + g % nbar, (g / nbar) & 1);
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

// The float2 at p in the shared memory of block `rank` of the cluster.
__device__ __forceinline__ float2 ld_cluster(const float2* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(r)
               : "memory");
  return v;
}

// Sums over the cluster's blocks, in rank order, of the pairs each block
// left at part[i] (i < BM), after a barrier of the cluster (of the block
// alone where S = 1): every block gets the same bits.
__device__ __forceinline__ float2 cluster_sum(const float2* part, int i,
                                              int S) {
  if (S == 1) return part[i];
  float2 s = make_float2(0.f, 0.f);
  for (int r = 0; r < S; ++r) {
    const float2 v = ld_cluster(part + i, r);
    s.x += v.x;
    s.y += v.y;
  }
  return s;
}

__device__ __forceinline__ void cluster_or_block_sync(int S) {
  if (S == 1)
    __syncthreads();
  else
    cluster_sync();
}

// A block of BM rows (64 or 32) whose share of K covers at most NCS slices
// of 64 columns. Where BM * NCS <= 192 (dln at 48 registers a thread at
// most) two blocks share an SM.
template <int BM, int NCS>
__global__ void __launch_bounds__(kThreads, BM * NCS <= 192 ? 2 : 1)
    patch_merge_bwd_rows(const __grid_constant__ Params p) {
  constexpr int WM = BM / 16, WN = kWarps / WM;
  constexpr int NT = kS / 8 / WN;   // n-tiles of a warp in a 64-wide slot
  extern __shared__ __align__(1024) unsigned char smem[];
  const Args& a = p.a;
  const int M = a.M, K = a.K, KS = a.ks, ld = KS + 8, S = a.split;
  const int ncs = (KS + kS - 1) / kS, nch = (a.O + kS - 1) / kS;
  const int kb = (int)(blockIdx.x & (S - 1)) * KS;   // the block's columns
  const int rb = (int)(blockIdx.x >> a.split_log2), m0 = rb * BM;
  const int warp = threadIdx.x >> 5, lane = lane_id(), g = lane >> 2,
            t = lane & 3;
  const int mi = warp % WM, ni = warp / WM;
  const int wr = kRows * mi, wc = 8 * NT * ni;   // the warp's rows, columns
  // Dynamic shared memory, from its first 1024-byte boundary (the
  // swizzle's period): the ring; the block's rows of x [BM][ks + 8], gamma
  // and beta [ks] (bf16); mu, inv, the means of the LayerNorm backward
  // [2][BM], its row sums [2][WN][BM] and the pairs the cluster exchanges
  // [2][BM] (fp32); the ring's mbarriers and counts. The padded row
  // stride keeps the fragment-order reads of x free of bank conflicts.
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  bf16* xt = reinterpret_cast<bf16*>(base) + a.stages * kSlice;
  bf16* gs = xt + BM * ld;
  bf16* bs = gs + KS;
  float* mu = reinterpret_cast<float*>(bs + KS);
  float* inv = mu + BM;
  float* mm = inv + BM;
  float* red = mm + 2 * BM;
  float2* xch = reinterpret_cast<float2*>(red + 2 * WN * BM);
  uint64_t* bars = reinterpret_cast<uint64_t*>(xch + 2 * BM);
  const int nbar = a.stages / a.group;
  Ring ring{reinterpret_cast<bf16*>(base), bars,
            reinterpret_cast<int*>(bars + nbar), nch * (1 + ncs), 1 + ncs,
            nbar};
  // the plan's bytes (ops/ln_lora.py:merge_bwd_plan) must hold this layout
  if (reinterpret_cast<unsigned char*>(ring.held + nbar) - smem >
          dynamic_smem_bytes() ||
      a.group > kGroupMax || nbar < 2 || ncs > NCS ||
      WM * 2 * KS * (int)sizeof(float) >
          a.stages * kSlice * (int)sizeof(bf16))
    __trap();

  // The block's rows of x (its share of each, as runs of C), gamma and
  // beta by cp.async, while the ring's first groups stream in
  const int vr = KS / 8;   // 16-byte copies a row
  for (int v = threadIdx.x; v < BM * vr; v += kThreads) {
    const int i = v / vr, k = kb + 8 * (v - i * vr);
    const bool in = m0 + i < M;
    cp_async16(xt + i * ld + (k - kb), in ? a.x + x_off(a, m0 + i, k) : a.x,
               in);
  }
  for (int v = threadIdx.x; v < vr; v += kThreads) {
    cp_async16(gs + 8 * v, a.gamma + kb + 8 * v, true);
    cp_async16(bs + 8 * v, a.beta + kb + 8 * v, true);
  }
  cp_async_commit();
  ring.start(p);
  cp_async_wait<0>();
  __syncthreads();

  // ---- statistics: the block's sums of x and x^2 over its columns, then
  // the cluster's (var = E[x^2] - E[x]^2 in fp32, as _layer_norm) --------
  for (int i = warp; i < BM; i += kWarps) {
    float s = 0.f, q = 0.f;
    for (int k = 2 * lane; k < KS; k += 64) {
      const float2 v = bf2(xt + i * ld + k);
      s += v.x + v.y;
      q += v.x * v.x + v.y * v.y;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (lane == 0) xch[i] = make_float2(s, q);
  }
  cluster_or_block_sync(S);
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    const float2 sq = cluster_sum(xch, i, S);
    const float mean = sq.x / K;
    const bool in = m0 + i < M;
    mu[i] = in ? mean : 0.f;
    inv[i] = in ? rsqrtf(sq.y / K - mean * mean + kEps) : 0.f;
  }
  __syncthreads();

  // ---- bf16(ln), the weight product's rows, to lnd [M, K] -----------------
  for (int i = warp; i < BM && m0 + i < M; i += kWarps) {
    bf16* out = a.lnd + (size_t)(m0 + i) * K + kb;
    for (int k = 2 * lane; k < KS; k += 64) {
      const float2 xv = bf2(xt + i * ld + k), gm = bf2(gs + k),
                   be = bf2(bs + k);
      st_bf2(out + k, ln_val(xv.x, mu[i], inv[i], gm.x, be.x),
             ln_val(xv.y, mu[i], inv[i], gm.y, be.y));
    }
  }

  // ---- dln = gy W over the hidden in chunks of 64 columns ----------------
  float dln[NCS][NT][4];
#pragma unroll
  for (int cs = 0; cs < NCS; ++cs) zero<NT>(dln[cs]);
  for (int j = 0; j < nch; ++j) {
    const int ks = ksteps(a.O, j);
    // gy's A fragments of the warp's rows (gp = gy), once a chunk
    uint32_t af[kS / 16][4];
    a_frags_slot(af, ring.next(p), wr, ks);
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs)
      if (cs < ncs) {
        const bf16* sl = ring.next(p);
        if (kS * cs + wc < KS) mma_slot_t<NT>(dln[cs], af, sl, wc, ks);
      }
  }

  // ---- LayerNorm backward: dxhat = dln gamma in place of dln; the warps'
  // 16-row partials of dgamma and dbeta into the ring's slots [WM][2][ks]
  // (free once every warp is past its last slot); the rows' sums of dxhat
  // and dxhat xhat. Rows past M have gy, mu and inv 0: they add nothing --
  __syncthreads();
  float* gbs = reinterpret_cast<float*>(ring.buf);
  float rs1[2] = {0.f, 0.f}, rs2[2] = {0.f, 0.f};
#pragma unroll
  for (int cs = 0; cs < NCS; ++cs) {
    if (cs >= ncs || kS * cs + wc >= KS) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = kS * cs + wc + 8 * nt + 2 * t;
      const float2 gm = bf2(gs + c);
      float cg[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wr + g + 8 * half;
        const float e0 = dln[cs][nt][2 * half], e1 = dln[cs][nt][2 * half + 1];
        const float2 xv = bf2(xt + rl * ld + c);
        const float xh0 = (xv.x - mu[rl]) * inv[rl];
        const float xh1 = (xv.y - mu[rl]) * inv[rl];
        const float v0 = e0 * gm.x, v1 = e1 * gm.y;
        rs1[half] += v0 + v1;
        rs2[half] += v0 * xh0 + v1 * xh1;
        cg[0] += e0 * xh0;
        cg[1] += e1 * xh1;
        cb[0] += e0;
        cb[1] += e1;
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
        float* gw = gbs + mi * 2 * KS;
        *reinterpret_cast<float2*>(gw + c) = make_float2(cg[0], cg[1]);
        *reinterpret_cast<float2*>(gw + KS + c) = make_float2(cb[0], cb[1]);
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
  // the block's row sums over its WN warps, in order, for the cluster; the
  // block's dgamma / dbeta partials over its WM row tiles, in order, to
  // its columns of gb [row blocks][2][K]
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    float u = 0.f, v = 0.f;
    for (int w = 0; w < WN; ++w) {
      u += red[w * BM + i];
      v += red[(WN + w) * BM + i];
    }
    xch[BM + i] = make_float2(u, v);
  }
  for (int c = threadIdx.x; c < 2 * KS; c += kThreads) {
    float v = 0.f;
    for (int w = 0; w < WM; ++w) v += gbs[w * 2 * KS + c];
    const int h = c >= KS;
    a.gb[(size_t)rb * 2 * K + h * K + kb + c - h * KS] = v;
  }
  cluster_or_block_sync(S);
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    const float2 uv = cluster_sum(xch + BM, i, S);
    mm[i] = uv.x / K;
    mm[BM + i] = uv.y / K;
  }
  __syncthreads();

  // ---- dx = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), in place
  // of the block's x (each element read and written by one thread) --------
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wr + g + 8 * half;
    const float mn = mu[rl], iv = inv[rl], m1 = mm[rl], m2 = mm[BM + rl];
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs) {
      if (cs >= ncs || kS * cs + wc >= KS) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bf16* px = xt + rl * ld + kS * cs + wc + 8 * nt + 2 * t;
        const float2 xv = bf2(px);
        const float xh0 = (xv.x - mn) * iv, xh1 = (xv.y - mn) * iv;
        st_bf2(px, iv * (dln[cs][nt][2 * half] - m1 - xh0 * m2),
               iv * (dln[cs][nt][2 * half + 1] - m1 - xh1 * m2));
      }
    }
  }
  __syncthreads();
  // to dx as the runs the rows came in as, 16 bytes a store
  for (int v = threadIdx.x; v < BM * vr; v += kThreads) {
    const int i = v / vr, k = kb + 8 * (v - i * vr);
    if (m0 + i < M)
      *reinterpret_cast<uint4*>(a.dx + x_off(a, m0 + i, k)) =
          *reinterpret_cast<const uint4*>(xt + i * ld + (k - kb));
  }
  // no block of the cluster leaves while another may read its row sums
  if (S > 1) cluster_sync();
}

// row blocks of S blocks each (a cluster where S > 1)
template <int BM, int NCS>
cudaError_t launch_rows(const Params& p, int blocks, int smem,
                        cudaStream_t st) {
  auto kern = patch_merge_bwd_rows<BM, NCS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int S = p.a.split;
  if (S == 1) {
    kern<<<blocks, kThreads, smem, st>>>(p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = S;
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

// Kernel 3 backward: x the [.., H, W, C] stream gathered 2x2 (merge_wh =
// W / 2, M = L H / 2 W / 2 merged rows of K = 4C), wt = W [O, K] in its
// module layout, read in place by TMA; gy [M, O]. bm (64 or 32), split
// (the blocks of a cluster that split K: 1, 2, 4 or 8), the ring's stages
// and group, and the row kernel's shared-memory bytes smem are the
// caller's launch plan (ops/ln_lora.py:merge_bwd_plan); the kernel traps
// if smem does not hold its layout. Scratch: lnd [M, K] bf16; gb
// [ceil(M / bm), 2, K] and the weight-gradient partials part [sw, O, K]
// fp32. Outputs: dx; dgb [2, K], dwt [O, K] (fp32).
extern "C" int mtlora_merge_ln_bwd(
    const void* x, const void* gamma, const void* beta, const void* wt,
    const void* gy, void* dx, void* lnd, void* gb, void* part, void* dgb,
    void* dwt, int M, int C, int O, int merge_wh, int bm, int split,
    int stages, int group, int smem, int sw, void* stream) {
  const int K = 4 * C;
  int log2 = 0;
  while (log2 < 3 && (1 << log2) < split) ++log2;
  if (split < 1 || split > kSplitMax || (1 << log2) != split)
    return (int)cudaErrorInvalidValue;
  const int ks = K / split, ncs = (ks + kS - 1) / kS;
  if (M < 1 || C < 8 || C % 8 || O < 16 || O % 16 || merge_wh < 1 ||
      M % merge_wh || sw < 1 || !(bm == 32 || bm == 64) ||
      ks % (bm == 64 ? 32 : 16) || ncs > (bm == 64 ? 3 : 8) || group < 1 ||
      group > kGroupMax || stages % group || stages < 2 * group)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of x, gamma, beta and dx, TMA boxes of gy and W
  if (misaligned(x) || misaligned(gamma) || misaligned(beta) ||
      misaligned(wt) || misaligned(gy) || misaligned(dx) || misaligned(lnd))
    return (int)cudaErrorMisalignedAddress;
  Params p;
  Args& a = p.a;
  a.x = static_cast<const bf16*>(x);
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.dx = static_cast<bf16*>(dx);
  a.lnd = static_cast<bf16*>(lnd);
  a.gb = static_cast<float*>(gb);
  a.M = M;
  a.C = C;
  a.K = K;
  a.O = O;
  a.Wh = merge_wh;
  a.bm = bm;
  a.ks = ks;
  a.split = split;
  a.split_log2 = log2;
  a.stages = stages;
  a.group = group;
  a.gy_bytes = bm * kS * (int)sizeof(bf16);
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  if (!box_map(&p.maps[kGy], gy, M, O, bm) || !box_map(&p.maps[kW], wt, O, K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const int blocks = (M + bm - 1) / bm;
  cudaError_t e =
      bm == 64   ? launch_rows<64, 3>(p, blocks, smem, st)
      : ncs <= 6 ? launch_rows<32, 6>(p, blocks, smem, st)
                 : launch_rows<32, 8>(p, blocks, smem, st);
  if (e != cudaSuccess) return (int)e;

  // dW^T [O, K] = bf16(gy)^T bf16(ln)
  const MatSrc gp{static_cast<const bf16*>(gy), O, 1.f, 0}, ln{a.lnd, K, 1.f,
                                                                0};
  e = wgrad(gp, ln, M, O, K, sw, static_cast<float*>(part),
            static_cast<float*>(dwt), st);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_parts(a.gb, blocks, 2 * (size_t)K, static_cast<float*>(dgb),
                        st);
}
