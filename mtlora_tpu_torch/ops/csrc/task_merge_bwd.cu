// The factored per-task patch merge's backward (kernel 6b) for Hopper: one
// row kernel that walks the tasks, then the weight product and the
// fixed-order sums.
//
// Replaces mtlora_tpu/ops/pallas_task_merge.py: _tm_bwd_kernel (:115),
// launched by _tm_bwd_rule (:300, call :313; train_w: the reduction
// trains) from the custom VJP of task_merge_ln_linear. Task t's stream,
// formed from the shared rows (task_merge.cuh):
//   y_t = ((base + c1_t pre) + c2_t p2) + midc_t Bs_t        (fp32)
// and, with its LN recomputed, the cast points of _tm_bwd_kernel:
//   dln   = bf16(gy_t) W               dgamma = sum dln xhat, dbeta = sum dln
//   dy_t  = inv (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dln g
//   dbase = sum_t dy_t, dpre = sum_t c1_t dy_t, dp2 = sum_t c2_t dy_t
//           (fp32, in task order, rounded once)
//   dU_t  = bf16(dy_t)                 dmidc_t = bf16(dU_t Bs_t^T)
//   dBs_t = midc_t^T dU_t  (fp32)      dW^T = sum_t bf16(gy_t)^T bf16(ln_t)
//
// What bounds it: the bytes of gy, the shared rows, their three gradients
// and the bf16(ln) rows the weight product reads, and the dln product
// (2 T Mm K O FLOP). The TPU kernel keeps a row block's T tasks in one
// grid step: the shared rows loaded once, the tasks walked in order, the
// three shared gradients summed in VMEM and dU never leaving it. Here, as
// kernel 3b's row kernel (merge_ln_bwd.cu), with the tasks walked in
// groups of TG inside it:
//   - a block of 8 warps owns 32 merged rows and a share of K = 4C: the
//     blocks of a cluster (1, 2, 4 or 8) split K, each taking ks = K / S
//     columns, and read each other's LayerNorm row sums through
//     distributed shared memory, in rank order, so that every block gets
//     the same bits. One exchange serves a group's TG tasks;
//   - the block's shared rows (base, pre, p2) arrive once, by cp.async, as
//     the runs of C of the 2x2 gather (16-byte copies), and stay; per
//     group the rank rows of its tasks' source tokens, their slices of Bs
//     and their rows' drop-path coefficients arrive one group ahead (a
//     double buffer). y_t is formed once, in fp32, into a tile that the
//     statistics, bf16(ln) and the LayerNorm backward read: no second
//     formation of the streams;
//   - per hidden chunk of 64 the gy tiles of the group's tasks (a 3-d
//     tensor map [T][Mm][O], two tasks a box, zero past the rows and
//     tasks) and W's slices of the block's columns stream through a ring
//     of chunks of 64 x 64 slots by TMA (128-byte swizzle), walked without
//     block barriers, W in its module layout [O, K] (ldmatrix.trans; no
//     copy of W per call): each W fragment serves the TG tasks, so W's
//     traffic from L2 is that of TG * 32 rows. dln += gy W by mma.sync on
//     ldmatrix fragments; dln of the group's tasks and the three task sums
//     stay in registers ((TG + 3) x 32 x ks / 256 fp32 a thread), which
//     the launch plan (ops/task_merge.py:task_merge_bwd_plan) sizes with
//     TG, S and the ring; the kernel traps if the plan's bytes do not hold
//     its layout;
//   - per task dU_t = bf16(dy_t) is a bf16 tile in shared memory, never in
//     device memory: dmidc_t = bf16(dU_t Bs_t^T) and the block's partial
//     of dBs_t^T = dU_t^T midc_t come from it by mma.sync; the blocks of a
//     cluster sum their dBs partials (and, where they split a run of C,
//     dmidc's partial sums) through distributed shared memory in rank
//     order; the row blocks' dBs partials [row blocks][T][C][8] and
//     dgamma / dbeta partials [row blocks][2][K] are summed in a fixed
//     order;
//   - the rows' bf16(ln) go to lnd [T * Mm, K] for the weight product
//     dW^T = gp^T bf16(ln) (lnk::wgrad: fp32 partials per stripe of rows,
//     summed in a fixed order). Deterministic, no fp32 atomics.

#include "row_block.cuh"
#include "task_merge.cuh"
#include "tma.cuh"

namespace {

using namespace lnk;
using tmk::dot8;
using tmk::ld16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 32;              // merged rows a block
constexpr int kS = 64;               // a slot and a hidden chunk: 64 wide
constexpr int kSlice = kS * kS;      // elements of a slot
constexpr int kChunkMax = 6;         // slots a chunk: gy's, then W's
constexpr int kSplitMax = 8;         // blocks of a cluster, at most
constexpr int kR = tmk::S;           // rank values a token (r1 + r2)
static_assert(kS == kSliceW, "tma.cuh: swz");

// gy as a 3-d map [T][Mm][O] (boxes of 64 columns, kBM rows and one or two
// tasks) and W as a 2-d map [O][K] (64 x 64 boxes), 128-byte swizzle.
enum { kGy, kW, kMaps };

struct Args {
  const bf16 *base, *pre, *p2, *mid, *bs, *gamma, *beta;
  const float* coef;        // [T][B][2]
  bf16 *lnd, *dbase, *dpre, *dp2, *dmid;
  float *gb, *pbs;
  int T, M, B, C, K, O, Wh, per_sample, tokens;
  int ks, split, split_log2;   // columns of K a block, blocks of a cluster
  int runs, share, cw;   // runs of C a block holds (1 where it holds part
                         // of one), blocks sharing a run, columns of a run
                         // the block holds: min(ks, C)
  int tg, ngy, depth;    // tasks a group, gy slots a chunk, tasks a gy box
  int stages;            // ring slots (whole chunks)
};

struct Params {
  Args a;
  CUtensorMap maps[kMaps];
};

struct Box {
  int map, c0, r0, z;
};

// Element (m, k) of the merged rows in the [B*L, C] rows: run q = di + 2 dj
// of row m.
__device__ __forceinline__ size_t x_off(const Args& a, int m, int k) {
  const int q = k / a.C, c = k - q * a.C;
  const int rr = m / a.Wh, j = m - rr * a.Wh;
  return ((size_t)(2 * rr + (q & 1)) * (2 * a.Wh) + 2 * j + (q >> 1)) *
             a.C + c;
}

// The source token of run q of merged row m.
__device__ __forceinline__ int token(const Args& a, int m, int q) {
  const int rr = m / a.Wh, j = m - rr * a.Wh;
  return (2 * rr + (q & 1)) * (2 * a.Wh) + 2 * j + (q >> 1);
}

__device__ __forceinline__ void tma_box3(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int r0,
                                         int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(z),
      "r"(smem_u32(bar))
      : "memory");
}

// Slot i of chunk q of a block: per task group and hidden chunk the gy
// boxes of the group's tasks (depth tasks each), then W's slices of the
// block's columns.
__device__ __forceinline__ Box box_of(const Args& a, int q, int i, int nch) {
  const int grp = q / nch, j = q - grp * nch;
  if (i < a.ngy)
    return Box{kGy, kS * j, (int)(blockIdx.x >> a.split_log2) * kBM,
               grp * a.tg + a.depth * i};
  const int kb = (int)(blockIdx.x & (a.split - 1)) * a.ks;
  return Box{kW, kb + kS * (i - a.ngy), kS * j, 0};
}

// The ring of a block, in chunks of per slots (2-tail's and 3b's ring, a
// chunk a group): one mbarrier a chunk that its boxes complete, and one
// count a chunk of the warps done with it. Every warp calls chunk() at the
// same points of its own walk, and the chunk it returns is resident until
// its next call: that call first hands the chunk back (the last of the
// kWarps warps to hand a chunk back starts the chunk nbar ahead into its
// slots), then waits on the next chunk's mbarrier. The walk runs on across
// the task groups.
struct Ring {
  bf16* buf;       // 1024-byte aligned
  uint64_t* bars;  // nbar
  int* held;       // nbar
  int total, per, nch, nbar;
  int g = 0;       // chunks taken

  // The calling warp starts chunk q: lane k box k, all at once, lane 0
  // first posting the chunk's bytes on its mbarrier.
  __device__ __forceinline__ void issue(const Params& p, int q) {
    if (q >= total) return;
    const Args& a = p.a;
    const int k = lane_id();
    Box b{0, 0, 0, 0};
    if (k < per) b = box_of(a, q, k, nch);
    const int bytes = (a.ngy * a.depth * kBM + (per - a.ngy) * kS) * kS *
                      (int)sizeof(bf16);
    uint64_t* bar = bars + q % nbar;
    if (k == 0) mbar_expect(bar, bytes);
    __syncwarp();
    if (k < per) {
      bf16* dst = buf + ((q % nbar) * per + k) * kSlice;
      if (b.map == kGy)
        tma_box3(dst, &p.maps[kGy], bar, b.c0, b.r0, b.z);
      else
        tma_box(dst, &p.maps[kW], bar, b.c0, b.r0);
    }
  }

  // Thread 0 sets up the mbarriers and counts, warp 0 starts the first
  // nbar chunks; the block meets at a barrier before the first chunk().
  __device__ __forceinline__ void start(const Params& p) {
    if (threadIdx.x == 0)
      for (int k = 0; k < nbar; ++k) {
        mbar_init(bars + k);
        held[k] = 0;
      }
    if (threadIdx.x < 32)
      for (int k = 0; k < nbar; ++k) issue(p, k);
  }

  __device__ __forceinline__ const bf16* chunk(const Params& p) {
    if (g > 0) {
      // the warp is done with chunk g - 1
      __syncwarp();
      int last = 0;
      if (lane_id() == 0) {
        __threadfence_block();
        last = atomicAdd(held + (g - 1) % nbar, 1) ==
               kWarps * ((g - 1) / nbar + 1) - 1;
      }
      if (__shfl_sync(0xffffffffu, last, 0)) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(p, g - 1 + nbar);
      }
    }
    mbar_wait(bars + g % nbar, (g / nbar) & 1);
    const bf16* c = buf + (g % nbar) * per * kSlice;
    ++g;
    return c;
  }
};

// 8 bytes global -> shared (8-byte aligned), through L1.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

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

// Sums over the n blocks of the cluster from rank r0 on, in rank order, of
// the pairs each left at part[i], after a barrier of the cluster (n == 1:
// the block's own, after a barrier of the block): every block gets the
// same bits.
__device__ __forceinline__ float2 cluster_sum(const float2* part, int i,
                                              int r0, int n) {
  if (n == 1) return part[i];
  float2 v[kSplitMax];
#pragma unroll
  for (int r = 0; r < kSplitMax; ++r)
    if (r < n) v[r] = ld_cluster(part + i, r0 + r);
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int r = 0; r < kSplitMax; ++r)
    if (r < n) {
      s.x += v[r].x;
      s.y += v[r].y;
    }
  return s;
}

__device__ __forceinline__ void cluster_or_block_sync(int S) {
  if (S == 1)
    __syncthreads();
  else
    cluster_sync();
}

// For the tasks t0.. of a group, by cp.async: the rank rows of the block's
// source tokens [tg][kBM][runs][8] and the slices of Bs [tg][cw][8]
// (bf16), the coefficients (c1, c2) of the samples of the block's rows
// [tg][kBM + 1][2] (fp32, from the first sample b0 on); zero past M and T.
__device__ __forceinline__ void stage_group(const Args& a, int t0, int m0,
                                            int q0, int cb0, bf16* ms,
                                            bf16* bsb, float* cf) {
  const int rows = kBM * a.runs;
  for (int v = threadIdx.x; v < a.tg * rows; v += kThreads) {
    const int tt = v / rows, w = v - tt * rows, i = w / a.runs,
              r = w - i * a.runs, m = m0 + i, t = t0 + tt;
    const bool in = m < a.M && t < a.T;
    const bf16* src =
        in ? a.mid + ((size_t)t * a.tokens + token(a, m, q0 + r)) * kR
           : a.mid;
    cp_async16(ms + v * kR, src, in);
  }
  for (int v = threadIdx.x; v < a.tg * a.cw; v += kThreads) {
    const int tt = v / a.cw, c = v - tt * a.cw, t = t0 + tt;
    const bool in = t < a.T;
    cp_async16(bsb + v * kR,
               in ? a.bs + ((size_t)t * a.C + cb0 + c) * kR : a.bs, in);
  }
  const int b0 = m0 / a.per_sample;
  const int nb = (min(m0 + kBM, a.M) - 1) / a.per_sample + 1 - b0;
  for (int v = threadIdx.x; v < a.tg * (kBM + 1); v += kThreads) {
    const int tt = v / (kBM + 1), j = v - tt * (kBM + 1), t = t0 + tt;
    if (t < a.T && j < nb) {
      cp_async8(cf + 2 * v, a.coef + ((size_t)t * a.B + b0 + j) * 2);
    } else {
      cf[2 * v] = 0.f;
      cf[2 * v + 1] = 0.f;
    }
  }
}

// A block of kBM rows whose share of K covers at most NCS slices of 64
// columns, walking the tasks in groups of TG (dln of TG tasks and the
// three task sums in registers), one block an SM.
template <int NCS, int TG>
__global__ void __launch_bounds__(kThreads, 1)
    task_merge_bwd_rows(const __grid_constant__ Params p) {
  constexpr int BM = kBM, WM = BM / 16, WN = kWarps / WM;
  constexpr int NT = kS / 8 / WN;   // n-tiles of a warp in a 64-wide slot
  constexpr int RW = BM / kWarps;   // rows of a warp in the row passes
  constexpr int DEPTH = TG >= 2 ? 2 : 1;   // tasks a gy box
  static_assert(NT == 2, "one ldmatrix.x4.trans a k-step and slot");
  extern __shared__ __align__(1024) unsigned char smem[];
  const Args& a = p.a;
  const int M = a.M, K = a.K, KS = a.ks, ld = KS + 8, S = a.split;
  const int ncs = (KS + kS - 1) / kS, nch = (a.O + kS - 1) / kS;
  const int rank = (int)(blockIdx.x & (S - 1)), kb = rank * KS;
  const int rb = (int)(blockIdx.x >> a.split_log2), m0 = rb * BM;
  const int q0 = kb / a.C, cb0 = kb - q0 * a.C;   // first run, its column
  const int warp = threadIdx.x >> 5, lane = lane_id(), g = lane >> 2,
            t4 = lane & 3;
  const int mi = warp % WM, ni = warp / WM;
  const int wr = kRows * mi, wc = 8 * NT * ni;   // the warp's rows, columns
  const int groups = (a.T + TG - 1) / TG;
  const int mrow = BM * a.runs * kR, mtask = a.cw * kR;   // staged, a task
  // Dynamic shared memory, from its first 1024-byte boundary (the
  // swizzle's period): the ring; the shared rows base, pre, p2 [3][BM][ks
  // + 8] and dU of the group's tasks [TG][BM][ks + 8] (bf16); their y
  // [TG][BM][ks + 8] (fp32); their rank rows [2][TG][BM][runs][8] and Bs
  // slices [2][TG][cw][8] (bf16, two groups); gamma and beta [ks] (bf16);
  // the coefficients of the rows' samples [2][TG][BM + 1][2]; mu, inv
  // [TG][BM], the means of the LayerNorm backward [2][TG][BM], its row
  // sums [2][TG][WN][BM], the warps' dgamma / dbeta sums [WM][2][ks],
  // dmidc's partial sums [TG][BM][8] and the block's dBs_t^T partials
  // [TG][cw][8] (fp32); the pairs the cluster exchanges [2][TG][BM]
  // (float2); the ring's mbarriers and counts. The padded row strides keep
  // the fragment-order reads and writes of the tiles free of bank
  // conflicts.
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  bf16* xs = reinterpret_cast<bf16*>(base) + a.stages * kSlice;   // 3 tiles
  bf16* du = xs + 3 * BM * ld;
  float* yf = reinterpret_cast<float*>(du + TG * BM * ld);
  bf16* ms = reinterpret_cast<bf16*>(yf + TG * BM * ld);
  bf16* bsb = ms + 2 * TG * mrow;
  bf16* gs = bsb + 2 * TG * mtask;
  bf16* bes = gs + KS;
  float* cfs = reinterpret_cast<float*>(bes + KS);
  float* mu = cfs + 2 * TG * (BM + 1) * 2;
  float* inv = mu + TG * BM;
  float* mm = inv + TG * BM;
  float* red = mm + 2 * TG * BM;
  float* gbs = red + 2 * TG * WN * BM;
  float* pd = gbs + WM * 2 * KS;
  float* pbm = pd + TG * BM * kR;
  float2* xch = reinterpret_cast<float2*>(pbm + TG * a.cw * kR);
  uint64_t* bars = reinterpret_cast<uint64_t*>(xch + 2 * TG * BM);
  const int per = a.ngy + ncs, nbar = a.stages / per;
  Ring ring{reinterpret_cast<bf16*>(base), bars,
            reinterpret_cast<int*>(bars + nbar), groups * nch, per, nch,
            nbar};
  // the plan's bytes (ops/task_merge.py:task_merge_bwd_plan) must hold
  // this layout
  if (reinterpret_cast<unsigned char*>(ring.held + nbar) - smem >
          dynamic_smem_bytes() ||
      per > kChunkMax || nbar < 2 || nbar * per != a.stages || ncs > NCS ||
      a.tg != TG || a.depth != DEPTH)
    __trap();

  // The block's shared rows (its share of each, as runs of C), gamma,
  // beta and the first group's rows by cp.async, while the ring's first
  // chunks stream in
  const int vr = KS / 8;   // 16-byte copies a row
  for (int v = threadIdx.x; v < BM * vr; v += kThreads) {
    const int i = v / vr, k = kb + 8 * (v - i * vr);
    const bool in = m0 + i < M;
    const size_t o = in ? x_off(a, m0 + i, k) : 0;
    const int d = i * ld + (k - kb);
    cp_async16(xs + d, a.base + o, in);
    cp_async16(xs + BM * ld + d, a.pre + o, in);
    cp_async16(xs + 2 * BM * ld + d, a.p2 + o, in);
  }
  for (int v = threadIdx.x; v < vr; v += kThreads) {
    cp_async16(gs + 8 * v, a.gamma + kb + 8 * v, true);
    cp_async16(bes + 8 * v, a.beta + kb + 8 * v, true);
  }
  stage_group(a, 0, m0, q0, cb0, ms, bsb, cfs);
  cp_async_commit();
  ring.start(p);
  for (int c = threadIdx.x; c < WM * 2 * KS; c += kThreads) gbs[c] = 0.f;

  // the staged sample (or the zero entry kBM past M) of the warp's rows in
  // the row passes and of the thread's rows in fragment order
  int cj[RW], ch[2];
#pragma unroll
  for (int u = 0; u < RW; ++u) {
    const int m = m0 + warp + kWarps * u;
    cj[u] = m < M ? m / a.per_sample - m0 / a.per_sample : BM;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wr + g + 8 * half;
    ch[half] = m < M ? m / a.per_sample - m0 / a.per_sample : BM;
  }

  // the task sums of dy: dbase, dpre, dp2 (fp32, in task order)
  float sacc[3][NCS][NT][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs) zero<NT>(sacc[j][cs]);

  for (int grp = 0; grp < groups; ++grp) {
    const int t0 = grp * TG, nt = min(TG, a.T - t0);
    // the group's rows are staged, and every read of the group before (of
    // y, dU, the rank rows, Bs slices and coefficients) is done
    cp_async_wait<0>();
    __syncthreads();
    const int cur = grp & 1;
    if (grp + 1 < groups) {
      stage_group(a, t0 + TG, m0, q0, cb0, ms + (cur ^ 1) * TG * mrow,
                  bsb + (cur ^ 1) * TG * mtask,
                  cfs + (cur ^ 1) * TG * (BM + 1) * 2);
      cp_async_commit();
    }
    const bf16* mg = ms + cur * TG * mrow;
    const bf16* bg = bsb + cur * TG * mtask;
    const float2* cg =
        reinterpret_cast<const float2*>(cfs + cur * TG * (BM + 1) * 2);

    // ---- y_t (fp32) and the block's sums of y and y^2 over its columns,
    // per task and row; then the cluster's (var = E[y^2] - E[y]^2 in fp32,
    // as _layer_norm). A warp takes RW rows at once ------------------------
    for (int tt = 0; tt < nt; ++tt) {
      const bf16* bt = bg + tt * mtask;
      float* yt = yf + tt * BM * ld;
      float s[RW], q[RW], c1[RW], c2[RW];
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        s[u] = q[u] = 0.f;
        const float2 c = cg[tt * (BM + 1) + cj[u]];
        c1[u] = c.x;
        c2[u] = c.y;
      }
      for (int r = 0; r < a.runs; ++r) {
        uint4 mv[RW];
#pragma unroll
        for (int u = 0; u < RW; ++u)
          mv[u] = ld16(mg + tt * mrow + ((warp + kWarps * u) * a.runs + r) *
                                            kR);
        for (int c = 2 * lane; c < a.cw; c += 64) {
          const int k = r * a.cw + c;
          const uint4 b0 = ld16(bt + c * kR), b1 = ld16(bt + (c + 1) * kR);
#pragma unroll
          for (int u = 0; u < RW; ++u) {
            const int o = (warp + kWarps * u) * ld + k;
            const float2 vb = bf2(xs + o), vp = bf2(xs + BM * ld + o),
                         vq = bf2(xs + 2 * BM * ld + o);
            const float y0 =
                ((vb.x + c1[u] * vp.x) + c2[u] * vq.x) + dot8(mv[u], b0);
            const float y1 =
                ((vb.y + c1[u] * vp.y) + c2[u] * vq.y) + dot8(mv[u], b1);
            *reinterpret_cast<float2*>(yt + o) = make_float2(y0, y1);
            s[u] += y0 + y1;
            q[u] += y0 * y0 + y1 * y1;
          }
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
#pragma unroll
        for (int u = 0; u < RW; ++u) {
          s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
          q[u] += __shfl_xor_sync(0xffffffffu, q[u], o);
        }
      if (lane == 0)
#pragma unroll
        for (int u = 0; u < RW; ++u)
          xch[tt * BM + warp + kWarps * u] = make_float2(s[u], q[u]);
    }
    cluster_or_block_sync(S);
    for (int v = threadIdx.x; v < TG * BM; v += kThreads) {
      const int tt = v / BM, i = v - tt * BM;
      const bool in = m0 + i < M && tt < nt;
      float mean = 0.f, iv = 0.f;
      if (in) {
        const float2 sq = cluster_sum(xch, v, 0, S);
        mean = sq.x / K;
        iv = rsqrtf(sq.y / K - mean * mean + kEps);
      }
      mu[v] = mean;
      inv[v] = iv;
    }
    __syncthreads();

    // ---- bf16(ln_t), the weight product's rows, to lnd [T * M, K]: 8
    // columns a thread, 16 bytes a store -------------------------------------
    for (int v = threadIdx.x; v < nt * BM * vr; v += kThreads) {
      const int tt = v / (BM * vr), w = v - tt * (BM * vr), i = w / vr,
                k = 8 * (w - i * vr);
      if (m0 + i >= M) continue;
      const float mn = mu[tt * BM + i], iv = inv[tt * BM + i];
      const float* y = yf + (tt * BM + i) * ld + k;
      const float4 ya = *reinterpret_cast<const float4*>(y);
      const float4 yb = *reinterpret_cast<const float4*>(y + 4);
      const float yv[8] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
      const uint4 gv = ld16(gs + k), bv = ld16(bes + k);
      const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
      const __nv_bfloat162* bp = reinterpret_cast<const __nv_bfloat162*>(&bv);
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 gm = __bfloat1622float2(gp[e]),
                     be = __bfloat1622float2(bp[e]);
        o[e] = pack_bf2(ln_val(yv[2 * e], mn, iv, gm.x, be.x),
                        ln_val(yv[2 * e + 1], mn, iv, gm.y, be.y));
      }
      *reinterpret_cast<uint4*>(
          a.lnd + ((size_t)(t0 + tt) * M + m0 + i) * K + kb + k) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }

    // ---- dln_t = gy_t W over the hidden in chunks of 64 columns: each W
    // fragment serves the group's tasks -------------------------------------
    float dln[TG][NCS][NT][4];
#pragma unroll
    for (int tt = 0; tt < TG; ++tt)
#pragma unroll
      for (int cs = 0; cs < NCS; ++cs) zero<NT>(dln[tt][cs]);
    for (int j = 0; j < nch; ++j) {
      const int ksj = ksteps(a.O, j);
      const bf16* ch = ring.chunk(p);
#pragma unroll
      for (int cs = 0; cs < NCS; ++cs) {
        if (cs >= ncs || kS * cs + wc >= KS) continue;
        const bf16* w = ch + (a.ngy + cs) * kSlice;
#pragma unroll
        for (int k = 0; k < kS / 16; ++k) {
          if (k >= ksj) continue;
          uint32_t b[4];
          ldsm_x4_t(b, w + swz(16 * k + (lane & 15), wc + (lane >> 4) * 8));
#pragma unroll
          for (int tt = 0; tt < TG; ++tt) {
            if (tt >= nt) continue;
            uint32_t af[4];
            ldsm_x4(af, ch + (tt / DEPTH) * kSlice +
                            swz(kBM * (tt % DEPTH) + wr + (lane & 15),
                                16 * k + (lane >> 4) * 8));
            mma_bf16_16816(dln[tt][cs][0], af, b[0], b[1]);
            mma_bf16_16816(dln[tt][cs][1], af, b[2], b[3]);
          }
        }
      }
    }

    // ---- LayerNorm backward: dxhat = dln gamma in place of dln; the warps'
    // 16-row sums of dgamma and dbeta over the group's tasks onto gbs
    // [WM][2][ks] (task order); the rows' sums of dxhat and dxhat xhat.
    // Rows past M have gy, mu and inv 0: they add nothing -------------------
    float rs1[TG][2], rs2[TG][2];
#pragma unroll
    for (int tt = 0; tt < TG; ++tt)
      rs1[tt][0] = rs1[tt][1] = rs2[tt][0] = rs2[tt][1] = 0.f;
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs) {
      if (cs >= ncs || kS * cs + wc >= KS) continue;
#pragma unroll
      for (int n8 = 0; n8 < NT; ++n8) {
        const int c = kS * cs + wc + 8 * n8 + 2 * t4;
        const float2 gm = bf2(gs + c);
        float sg[2] = {0.f, 0.f}, sb[2] = {0.f, 0.f};
#pragma unroll
        for (int tt = 0; tt < TG; ++tt) {
          if (tt >= nt) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int rl = wr + g + 8 * half, ri = tt * BM + rl;
            const float e0 = dln[tt][cs][n8][2 * half],
                        e1 = dln[tt][cs][n8][2 * half + 1];
            const float2 y =
                *reinterpret_cast<const float2*>(yf + ri * ld + c);
            const float xh0 = (y.x - mu[ri]) * inv[ri];
            const float xh1 = (y.y - mu[ri]) * inv[ri];
            const float v0 = e0 * gm.x, v1 = e1 * gm.y;
            rs1[tt][half] += v0 + v1;
            rs2[tt][half] += v0 * xh0 + v1 * xh1;
            sg[0] += e0 * xh0;
            sg[1] += e1 * xh1;
            sb[0] += e0;
            sb[1] += e1;
            dln[tt][cs][n8][2 * half] = v0;
            dln[tt][cs][n8][2 * half + 1] = v1;
          }
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], o);
            sb[e] += __shfl_xor_sync(0xffffffffu, sb[e], o);
          }
        if (g == 0) {
          float2* pg = reinterpret_cast<float2*>(gbs + mi * 2 * KS + c);
          float2* pb = reinterpret_cast<float2*>(gbs + mi * 2 * KS + KS + c);
          const float2 og = *pg, ob = *pb;
          *pg = make_float2(og.x + sg[0], og.y + sg[1]);
          *pb = make_float2(ob.x + sb[0], ob.y + sb[1]);
        }
      }
    }
#pragma unroll
    for (int tt = 0; tt < TG; ++tt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          rs1[tt][half] += __shfl_xor_sync(0xffffffffu, rs1[tt][half], o);
          rs2[tt][half] += __shfl_xor_sync(0xffffffffu, rs2[tt][half], o);
        }
        if (t4 == 0) {
          const int rl = wr + g + 8 * half;
          red[(tt * 2 * WN + ni) * BM + rl] = rs1[tt][half];
          red[(tt * 2 * WN + WN + ni) * BM + rl] = rs2[tt][half];
        }
      }
    __syncthreads();
    // the block's row sums over its WN warps, in order, for the cluster
    for (int v = threadIdx.x; v < TG * BM; v += kThreads) {
      const int tt = v / BM, i = v - tt * BM;
      float u = 0.f, w = 0.f;
      for (int n = 0; n < WN; ++n) {
        u += red[(tt * 2 * WN + n) * BM + i];
        w += red[(tt * 2 * WN + WN + n) * BM + i];
      }
      xch[TG * BM + v] = make_float2(u, w);
    }
    cluster_or_block_sync(S);
    for (int v = threadIdx.x; v < TG * BM; v += kThreads) {
      const float2 uv = cluster_sum(xch + TG * BM, v, 0, S);
      mm[v] = uv.x / K;
      mm[TG * BM + v] = uv.y / K;
    }
    __syncthreads();

    // ---- per task: dy_t = inv (dxhat - mean(dxhat) - xhat mean(dxhat
    // xhat)) onto the task sums (c1, c2 per row) and, as bf16, to dU_t's
    // tile; from it the rank gradients: dmidc_t = bf16(dU_t Bs_t^T) (m16 x
    // n8 tiles: 16 rows of a run, k its columns) and the block's partial of
    // dBs_t^T = dU_t^T midc_t (16 of the run's columns, k the rows, summed
    // over the block's runs) -------------------------------------------------
    const int tiles_m = (BM / 16) * a.runs, tiles_c = a.cw / 16;
#pragma unroll
    for (int tt = 0; tt < TG; ++tt) {
      if (tt >= nt) continue;
      bf16* dt = du + tt * BM * ld;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wr + g + 8 * half, ri = tt * BM + rl;
        const float mn = mu[ri], iv = inv[ri], m1 = mm[ri],
                    m2 = mm[TG * BM + ri];
        const float2 kc = cg[tt * (BM + 1) + ch[half]];
        const float k1 = kc.x, k2 = kc.y;
#pragma unroll
        for (int cs = 0; cs < NCS; ++cs) {
          if (cs >= ncs || kS * cs + wc >= KS) continue;
#pragma unroll
          for (int n8 = 0; n8 < NT; ++n8) {
            const int c = kS * cs + wc + 8 * n8 + 2 * t4;
            const float2 y =
                *reinterpret_cast<const float2*>(yf + ri * ld + c);
            const float xh0 = (y.x - mn) * iv, xh1 = (y.y - mn) * iv;
            const float d0 =
                iv * (dln[tt][cs][n8][2 * half] - m1 - xh0 * m2);
            const float d1 =
                iv * (dln[tt][cs][n8][2 * half + 1] - m1 - xh1 * m2);
            sacc[0][cs][n8][2 * half] += d0;
            sacc[0][cs][n8][2 * half + 1] += d1;
            sacc[1][cs][n8][2 * half] += k1 * d0;
            sacc[1][cs][n8][2 * half + 1] += k1 * d1;
            sacc[2][cs][n8][2 * half] += k2 * d0;
            sacc[2][cs][n8][2 * half + 1] += k2 * d1;
            st_bf2(dt + rl * ld + c, d0, d1);
          }
        }
      }
    }
    __syncthreads();
    // the tasks' dmidc tiles first, then their dBs tiles, so that the warps
    // share the longer ones
    for (int w = warp; w < nt * (tiles_m + tiles_c); w += kWarps) {
      const bool wm = w < nt * tiles_m;
      const int tt = wm ? w / tiles_m : (w - nt * tiles_m) / tiles_c;
      const int wt = wm ? w - tt * tiles_m
                        : tiles_m + (w - nt * tiles_m) - tt * tiles_c;
      const int t = t0 + tt;
      const bf16* dt = du + tt * BM * ld;
      const bf16* mt = mg + tt * mrow;
      const bf16* bt = bg + tt * mtask;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (wt < tiles_m) {
        const int rt = wt % (BM / 16), r = wt / (BM / 16);
        for (int kk = 0; kk < a.cw; kk += 16) {
          uint32_t af[4], b[2];
          ldsm_x4(af, dt + (16 * rt + (lane & 15)) * ld + r * a.cw + kk +
                          (lane >> 4) * 8);
          ldsm_x2_t(b, bt + (kk + (lane & 15)) * kR);
          mma_bf16_16816(acc, af, b[0], b[1]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = 16 * rt + g + 8 * half;
          if (a.share == 1) {
            if (m0 + i < M)
              st_bf2(a.dmid + ((size_t)t * a.tokens +
                               token(a, m0 + i, q0 + r)) * kR + 2 * t4,
                     acc[2 * half], acc[2 * half + 1]);
          } else {
            *reinterpret_cast<float2*>(pd + (tt * BM + i) * kR +
                                       2 * t4) =
                make_float2(acc[2 * half], acc[2 * half + 1]);
          }
        }
      } else {
        const int c0 = 16 * (wt - tiles_m);
        for (int r = 0; r < a.runs; ++r)
          for (int kk = 0; kk < BM; kk += 16) {
            uint32_t af[4], b[2];
            ldsm_x4_t(af, dt + (kk + (lane & 7) + ((lane >> 4) << 3)) *
                                   ld + r * a.cw + c0 +
                              ((lane >> 3) & 1) * 8);
            ldsm_x2_t(b, mt + ((kk + (lane & 15)) * a.runs + r) * kR);
            mma_bf16_16816(acc, af, b[0], b[1]);
          }
        float* pt = pbm + (tt * a.cw + c0) * kR;
        *reinterpret_cast<float2*>(pt + g * kR + 2 * t4) =
            make_float2(acc[0], acc[1]);
        *reinterpret_cast<float2*>(pt + (g + 8) * kR + 2 * t4) =
            make_float2(acc[2], acc[3]);
      }
    }

    // ---- the cluster's sums of the group's rank gradients ------------------
    cluster_or_block_sync(S);
    if (a.share > 1 && rank % a.share == 0)
      // a run split between `share` blocks: their partial sums of dmidc in
      // rank order, written by the first
      for (int v = threadIdx.x; v < nt * BM * kR / 2; v += kThreads) {
        const int tt = v / (BM * kR / 2), w = v - tt * (BM * kR / 2);
        const int i = w / (kR / 2), s = 2 * (w - i * (kR / 2));
        if (m0 + i >= M) continue;
        const float2 d = cluster_sum(reinterpret_cast<const float2*>(pd), v,
                                     rank, a.share);
        st_bf2(a.dmid + ((size_t)(t0 + tt) * a.tokens + token(a, m0 + i, q0)) *
                            kR + s,
               d.x, d.y);
      }
    // dBs_t^T [C][8] of the cluster: each block sums its share of the
    // elements over the blocks that hold column c (c / cw of each run of
    // `share`), in rank order, to the row block's partial
    {
      const int pe = a.C * kR / S, ng = S / a.share;
      for (int v = threadIdx.x; v < nt * pe / 2; v += kThreads) {
        const int tt = v / (pe / 2), e = rank * pe + 2 * (v - tt * (pe / 2));
        const int c = e / kR, q = c / a.cw;
        const float2* src = reinterpret_cast<const float2*>(
            pbm + (tt * a.cw + c - q * a.cw) * kR + (e - c * kR));
        float2 sum = make_float2(0.f, 0.f);
        if (S == 1) {
          sum = *src;
        } else {
          float2 u[kSplitMax];
#pragma unroll
          for (int j = 0; j < kSplitMax; ++j)
            if (j < ng) u[j] = ld_cluster(src, q + a.share * j);
#pragma unroll
          for (int j = 0; j < kSplitMax; ++j)
            if (j < ng) {
              sum.x += u[j].x;
              sum.y += u[j].y;
            }
        }
        *reinterpret_cast<float2*>(
            a.pbs + ((size_t)rb * a.T + t0 + tt) * a.C * kR + e) = sum;
      }
    }
  }

  // ---- the block's dgamma / dbeta over its WM row tiles, in order, to its
  // columns of gb [row blocks][2][K]; the task sums rounded once to bf16
  // over the shared rows (read no more) ------------------------------------
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * KS; c += kThreads) {
    float v = 0.f;
    for (int w = 0; w < WM; ++w) v += gbs[w * 2 * KS + c];
    const int h = c >= KS;
    a.gb[(size_t)rb * 2 * K + h * K + kb + c - h * KS] = v;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rl = wr + g + 8 * half;
#pragma unroll
    for (int cs = 0; cs < NCS; ++cs) {
      if (cs >= ncs || kS * cs + wc >= KS) continue;
#pragma unroll
      for (int n8 = 0; n8 < NT; ++n8) {
        const int c = kS * cs + wc + 8 * n8 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 3; ++j)
          st_bf2(xs + j * BM * ld + rl * ld + c, sacc[j][cs][n8][2 * half],
                 sacc[j][cs][n8][2 * half + 1]);
      }
    }
  }
  __syncthreads();
  // to dbase, dpre, dp2 as the runs the rows came in as, 16 bytes a store
  bf16* const outs[3] = {a.dbase, a.dpre, a.dp2};
  for (int v = threadIdx.x; v < BM * vr; v += kThreads) {
    const int i = v / vr, k = kb + 8 * (v - i * vr);
    if (m0 + i >= M) continue;
    const size_t o = x_off(a, m0 + i, k);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      *reinterpret_cast<uint4*>(outs[j] + o) =
          *reinterpret_cast<const uint4*>(xs + j * BM * ld + i * ld +
                                          (k - kb));
  }
  // no block of the cluster leaves while another may read its sums
  if (S > 1) cluster_sync();
}

// row blocks of S blocks each (a cluster where S > 1)
template <int NCS, int TG>
cudaError_t launch_rows(const Params& p, int blocks, int smem,
                        cudaStream_t st) {
  auto kern = task_merge_bwd_rows<NCS, TG>;
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

// The instances: (slices of 64 columns, tasks a group) whose dln and task
// sums, (TG + 3) NCS 8 fp32 a thread, stay at most 168 registers.
cudaError_t launch_plan(const Params& p, int ncs, int blocks, int smem,
                        cudaStream_t st) {
  const int tg = p.a.tg;
  if (ncs <= 2)
    return tg == 1   ? launch_rows<2, 1>(p, blocks, smem, st)
           : tg == 2 ? launch_rows<2, 2>(p, blocks, smem, st)
           : tg == 3 ? launch_rows<2, 3>(p, blocks, smem, st)
                     : launch_rows<2, 4>(p, blocks, smem, st);
  if (ncs == 3)
    return tg == 1 ? launch_rows<3, 1>(p, blocks, smem, st)
                   : launch_rows<3, 2>(p, blocks, smem, st);
  return launch_rows<4, 1>(p, blocks, smem, st);
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

// gy [T][Mm][O] as boxes of 64 columns, kBM rows and `depth` tasks, zero
// past the rows and tasks.
bool gy_map(CUtensorMap* m, const void* p, int T, int Mm, int O,
            int depth) {
  const cuuint64_t dims[3] = {(cuuint64_t)O, (cuuint64_t)Mm, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)O * sizeof(bf16),
                                 (cuuint64_t)Mm * O * sizeof(bf16)};
  const cuuint32_t box[3] = {kS, kBM, (cuuint32_t)depth};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(p), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Kernel 6 backward. base, pre, p2 [B*H*W, C], mid [T, B*H*W, 8] (the rank
// rows token-major, coefficients folded in), bs_cs [T, C, 8] (the scaled
// rank matrices), coef [T, B, 2] fp32 (c1, c2), gamma, beta [4C], wt = W
// [O, 4C] in its module layout, read in place by TMA, gy [T, B*H/2*W/2,
// O]. split (the blocks of a cluster that split K: 1, 2, 4 or 8), tg (the
// tasks a group), the ring's stages and the row kernel's shared-memory
// bytes smem are the caller's launch plan
// (ops/task_merge.py:task_merge_bwd_plan); the kernel traps if smem does
// not hold its layout. Scratch: lnd [T * Mm, 4C] bf16; gb [ceil(Mm / 32),
// 2, 4C], pbs [ceil(Mm / 32), T, C, 8] and the weight-gradient partials
// part [sw, O, 4C] fp32. Outputs: dbase, dpre, dp2 [B*H*W, C] and dmid [T,
// B*H*W, 8] bf16; dbs [T, C, 8], dgb [2, 4C], dwt [O, 4C] fp32.
extern "C" int mtlora_task_merge_bwd(
    const void* base, const void* pre, const void* p2, const void* mid,
    const void* bs_cs, const void* coef, const void* gamma,
    const void* beta, const void* wt, const void* gy, void* lnd, void* gb,
    void* pbs, void* part, void* dbase, void* dpre, void* dp2, void* dmid,
    void* dbs, void* dgb, void* dwt, int T, int B, int H, int W, int C,
    int O, int split, int tg, int stages, int smem, int sw, void* stream) {
  const int K = 4 * C;
  int log2 = 0;
  while (log2 < 3 && (1 << log2) < split) ++log2;
  if (split < 1 || split > kSplitMax || (1 << log2) != split || K % split)
    return (int)cudaErrorInvalidValue;
  const int ks = K / split, ncs = (ks + kS - 1) / kS;
  const int depth = tg >= 2 ? 2 : 1, ngy = (tg + depth - 1) / depth;
  if (T < 1 || B < 1 || H < 2 || W < 2 || H % 2 || W % 2 || C < 16 ||
      C % 16 || O < 16 || O % 16 || sw < 1 || ks % 16 || ncs > 4 ||
      (ks % C && C % ks) || tg < 1 || tg > (ncs <= 2 ? 4 : ncs == 3 ? 2 : 1) ||
      stages % (ngy + ncs) || stages < 2 * (ngy + ncs))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of the rows, TMA boxes of gy and W
  const void* ptrs[] = {base, pre, p2, mid, bs_cs, gamma, beta, wt, gy,
                        lnd, dbase, dpre, dp2, dmid};
  for (const void* q : ptrs)
    if (misaligned(q)) return (int)cudaErrorMisalignedAddress;
  Params p;
  Args& a = p.a;
  a.base = static_cast<const bf16*>(base);
  a.pre = static_cast<const bf16*>(pre);
  a.p2 = static_cast<const bf16*>(p2);
  a.mid = static_cast<const bf16*>(mid);
  a.bs = static_cast<const bf16*>(bs_cs);
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.coef = static_cast<const float*>(coef);
  a.lnd = static_cast<bf16*>(lnd);
  a.dbase = static_cast<bf16*>(dbase);
  a.dpre = static_cast<bf16*>(dpre);
  a.dp2 = static_cast<bf16*>(dp2);
  a.dmid = static_cast<bf16*>(dmid);
  a.gb = static_cast<float*>(gb);
  a.pbs = static_cast<float*>(pbs);
  a.T = T;
  a.B = B;
  a.per_sample = (H / 2) * (W / 2);
  a.M = B * a.per_sample;
  a.C = C;
  a.K = K;
  a.O = O;
  a.Wh = W / 2;
  a.tokens = B * H * W;
  a.ks = ks;
  a.split = split;
  a.split_log2 = log2;
  a.runs = ks >= C ? ks / C : 1;
  a.share = ks >= C ? 1 : C / ks;
  a.cw = ks >= C ? C : ks;
  a.tg = tg;
  a.depth = depth;
  a.ngy = ngy;
  a.stages = stages;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  if (!gy_map(&p.maps[kGy], gy, T, a.M, O, depth) ||
      !box_map(&p.maps[kW], wt, O, K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const int blocks = (a.M + kBM - 1) / kBM;
  cudaError_t e = launch_plan(p, ncs, blocks, smem, st);
  if (e != cudaSuccess) return (int)e;

  // dBs [T, C, 8]: the row blocks' partials summed in order
  e = sum_parts(a.pbs, blocks, (size_t)T * C * kR, static_cast<float*>(dbs),
                st);
  if (e != cudaSuccess) return (int)e;
  // dW^T [O, K] = bf16(gy)^T bf16(ln) over every task's rows
  const MatSrc gp{static_cast<const bf16*>(gy), O, 1.f, 0},
      ln{a.lnd, K, 1.f, 0};
  e = wgrad(gp, ln, T * a.M, O, K, sw, static_cast<float*>(part),
            static_cast<float*>(dwt), st);
  if (e != cudaSuccess) return (int)e;
  return (int)sum_parts(a.gb, blocks, 2 * (size_t)K, static_cast<float*>(dgb),
                        st);
}
