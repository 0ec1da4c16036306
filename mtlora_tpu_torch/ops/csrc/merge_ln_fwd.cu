// The fused patch merge's forward (kernel 3) for Hopper: the rows of a
// [.., H, W, C] stream gathered 2x2 (concat order k = (di + 2 dj) C + c),
//   ln = LN(x)                        fp32 statistics, var = E[x^2] - mu^2
//   y  = bf16(bf16(ln) W^T)           fp32 accumulate, rounded once
// with no bias and no adapter. Its backward is merge_ln_bwd.cu (kernel 3b).
//
// Replaces mtlora_tpu/ops/pallas_ln_lora.py: _merge_fwd_kernel (:465),
// launched by _merge_run_fwd (:574, call :580) through
// fused_merge_ln_linear (:550).
//
// What bounds it: a merged row of K = 4C inputs makes O = 2C outputs, 2 K O
// FLOP for 2 (K + O) bytes: 256-1024 FLOP a byte at the flagship's merges,
// about the card's ~295 ridge, so the bound is x's and y's bytes (the first
// merge) or the products (the last). What held the first port at a tenth
// of that bound was W: a block of 4 warps on 16 rows read all of W [O, K]
// as fragments from L2 for every 16 rows, M K O 2 / 16 bytes a merge (0.93
// GB at each of the flagship's, about 2.6 TB/s out of L2 whatever M, K and
// O), and its row loader took two integer divisions per bf16 pair. Design:
//   - a block owns BM merged rows and keeps their bf16(ln) [BM][K] in
//     shared memory, its 16-byte chunks of row r XOR-swizzled by r % 8 (no
//     padding: ldmatrix and the row loops read it without bank conflicts),
//     so that each W slot serves BM rows: W's L2 traffic M / BM K O 2
//     bytes. BM is the most rows whose tile leaves a ring of 4 slots: 128
//     up to K = 768, 64 up to 1536, then 32 and 16;
//   - two consumer warpgroups, 8 warps: BM / 32 row groups of 32 rows (16
//     at BM = 16), WN = 8 / (BM / 32) warps a row group. A row group loads
//     its rows of x by cp.async as the runs of C they are in x (16-byte
//     copies: C % 8 == 0), into the reference order, with no index
//     arithmetic per element (a row's base is stepped, each lane's column
//     offsets kept), then takes the statistics and writes bf16(ln) in x's
//     place in one pass (four rows of 16-byte pieces a warp in registers at
//     a time), meeting only its own warps. The next item's rows start
//     loading as soon as the group has read its tile, under the stores;
//   - W [O, K], in its module layout, streams through a ring of 64 x 64
//     slots by TMA (128-byte swizzle, zero outside the array): per pass of
//     up to WN 64-column output chunks and per 64-column slice of K, one
//     slot a chunk. Every warp reads every slot: its 64 / WN columns of
//     each chunk for its row group's rows, so that a warp multiplies 32
//     rows against each B fragment it loads and its A fragments serve the
//     pass's WN slots (mma.sync m16n8k16 on ldmatrix fragments, y in 64
//     fp32 registers a thread, no branch inside a slot's products);
//   - one producer warp only issues the ring's boxes: full and empty
//     mbarriers a slot, the consumer warps never meet at a block barrier.
//     Its warpgroup gives the consumers its registers (setmaxnreg: 232 a
//     consumer thread, against the 168 that nine warps leave). The variant
//     merge-fwd-refill-ring has the last of the 8 warps done with a group
//     of slots refill it (2-tail's ring): slower at every merge;
//   - the blocks are persistent and take items in turn, an item a row block
//     and one split of its chunks (split where the row blocks are few, so
//     that every SM takes work). The launch plan
//     (ops/ln_lora.py:merge_fwd_plan) owns rows, splits, the ring and the
//     shared-memory bytes; the kernel traps if the bytes do not hold its
//     layout; the last row block masks its rows past M;
//   - y is written from the accumulators, 4 bytes a lane. One fp32 sum per
//     output element in a fixed order: deterministic, no atomics.
// On an H100 (700 W) the products take about half of a merge and the
// statistics and bf16(ln) pass most of the rest; W's ring runs under the
// products (tools/ln_mlp_bwd_variants.py --time-merge, PARTS).
//
// The task mode (kernel 6, task_merge_fwd_rows: its own symbol, the same
// body) is the factored per-task merge's forward. It replaces
// mtlora_tpu/ops/pallas_task_merge.py: _tm_fwd_kernel (:70), launched by
// _tm_run_fwd (:255, call :264) through task_merge_ln_linear from
// task_merge_down. Task t's rows are never in device memory: per element
//   y_t = ((base + c1_t pre) + c2_t p2) + midc_t Bs_t      (fp32)
// of the 2x2 gather (the operands of task_merge.cuh; its sum of the rank
// term is 6b's), then LN and the product as above, y [T][M][O]. What
// bounds it: the products (2 T M K O FLOP) and the bytes of the shared
// rows (base, pre, p2: 6 bytes a source value, against T outputs of 2C a
// merged row). The first port read W from L2 for every 16 rows of a task
// (3.7 GB a merge) and formed each value twice with four divisions a pair.
// Here an item is a row block of one task, the tasks of a row block
// adjacent in the walk, so that the T blocks that read a row block's
// shared rows run at once and take them from HBM once; W's slots serve BM
// task rows, as kernel 3's at T B streams. A row group's LayerNorm pass
// forms its rows' y once, straight into registers (16-byte loads at each
// lane's column offsets, kept; a row's first token from one division),
// takes the statistics and writes bf16(ln) into the tile. Bs_t [C][8]
// (4K bytes: the tile's last two rows of the group, its columns swizzled
// so that the lanes' 16-byte reads meet no bank twice) is staged by
// cp.async where kernel 3 stages the next item's rows; the group meets
// once more before the pass writes those two rows. K up to kMaxKTask: y
// of a row takes 8 K / 256 registers a lane.

#include <type_traits>

#include "task_merge.cuh"
#include "tma.cuh"

namespace {

using namespace lnk;

constexpr int kWarps = 8;            // consumer warps of a block
// two consumer warpgroups and a producer warpgroup, whose one warp that
// issues the ring's boxes needs few registers: the consumers take the rest
// (setmaxnreg), 232 a thread against the 168 that nine warps leave
constexpr int kThreads = 32 * (kWarps + 4);
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kS = 64;               // a slot, a chunk, a slice of K: 64 wide
constexpr int kSlice = kS * kS;      // elements of a slot
constexpr int kGroupMax = 4;         // slots a ring group (the plan's)
constexpr int kMaxU = 2;             // 16-byte pieces of a row a loader lane
constexpr int kMaxK = 4096;          // the widest merged row

// 16-byte pieces of a row a lane takes in the LayerNorm pass at bm rows a
// block: 32 of them cover the widest row whose tile of bm rows leaves a
// ring of 4 slots (K 768, 1536, 3072 at 128, 64, 32 rows), or kMaxK
__host__ __device__ constexpr int ur_of(int bm) {
  return bm == 128 ? 3 : bm == 64 ? 6 : bm == 32 ? 12 : kMaxK / 256;
}
// The task mode's: the same rows a block, rows of at most kMaxKTask, and
// the pieces of a row a lane takes (its instances: 2 or 3 at 128 rows, 4 or
// 6 at 64, 8 at 32), a compile-time count so that no branch splits the
// pass's unrolled loops
constexpr int kMaxKTask = 2048;      // 6b's widest row
__host__ __device__ constexpr int ut_of(int bm, int K) {
  return bm == 128  ? (K <= 512 ? 2 : 3)
         : bm == 64 ? (K <= 1024 ? 4 : 6)
                    : kMaxKTask / 256;
}
static_assert(kS == kSliceW, "tma.cuh: swz");

struct Args {
  const bf16 *x, *gamma, *beta;
  bf16* y;
  int M, C, K, O, Wh;
  int bm;              // rows a block
  int splits;          // items of a row block, splitting its chunks
  int items;           // row blocks (of every task) x splits
  int stages, group;   // ring slots; slots a group (the plan's)
  // the task mode: x is the shared rows base; M merged rows a task
  const bf16 *pre, *p2;   // [B*L][C], as base
  const bf16 *mid, *bs;   // [T][B*L][8] rank rows, [T][C][8] scaled B
  const float* coef;      // [T][B][2] drop-path coefficients (c1, c2)
  int T, B, per_sample;   // tasks (1 in kernel 3), samples, rows a sample
};

struct Params {
  Args a;
  CUtensorMap w;       // W [O, K]: boxes of 64 x 64, 128-byte swizzle
};

// Element (r, k) of the bf16(ln) tile, rows of kp = K rounded up to 64: the
// 16-byte chunks of row r XOR-swizzled by r % 8.
__device__ __forceinline__ int tsw(int r, int kp, int k) {
  return r * kp + ((((k >> 3) ^ (r & 7))) << 3) + (k & 7);
}

// The q-th slot of an item (nci chunks from chunk c0, ncs slices of K):
// per pass of up to WN chunks, per slice cs, one slot a chunk. The box's
// (column, row) in W [O, K].
template <int WN>
__device__ __forceinline__ int2 slot_box(int q, int c0, int nci, int ncs) {
  const int pp = q / (WN * ncs), live = min(WN, nci - pp * WN);
  const int r = q - pp * WN * ncs, cs = r / live, i = r - cs * live;
  return make_int2(kS * cs, kS * (c0 + pp * WN + i));
}

// The two bf16 of v as floats (the first in the low half).
__device__ __forceinline__ float2 unpack_bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The block's walk over its items: item k is blockIdx.x + k gridDim.x.
struct Walk {
  int nitems, nch, nci, ncs;
  __device__ __forceinline__ Walk(const Args& a) {
    nitems = (a.items - (int)blockIdx.x + (int)gridDim.x - 1) /
             (int)gridDim.x;
    nch = (a.O + kS - 1) / kS;
    nci = nch / a.splits;
    ncs = (a.K + kS - 1) / kS;
  }
  __device__ __forceinline__ int item(int k) const {
    return (int)blockIdx.x + k * (int)gridDim.x;
  }
};

// The ring of W's slots: a.stages slots, each with a full mbarrier
// (the producer's expect_tx and the box's bytes) and an empty one (one
// arrival of each of the kWarps consumer warps, done with its reads). The
// producer walks the block's slots in order, waiting for a slot to be
// empty before it starts the next box there; every consumer warp takes
// every slot in the same order. No block barrier.
struct Ring {
  bf16* buf;              // 1024-byte aligned
  uint64_t *full, *empty;
  int slot = 0, phase = 0;

  __device__ __forceinline__ Ring(bf16* b, uint64_t* bars, int stages)
      : buf(b), full(bars), empty(bars + stages) {}

  __device__ __forceinline__ unsigned char* end(int stages) const {
    return reinterpret_cast<unsigned char*>(empty + stages);
  }

  // thread 0, before the block's one barrier
  __device__ __forceinline__ void init(int stages) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init_n(full + s, 1);
      mbar_init_n(empty + s, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The producer warp's walk: lane 0 starts every box.
  template <int WN>
  __device__ __forceinline__ void produce(const Params& p, const Walk& w) {
    const Args& a = p.a;
    if (lane_id() != 0) return;
    int s = 0, ph = 0;
    for (int k = 0; k < w.nitems; ++k) {
      const int c0 = w.item(k) % a.splits * w.nci;
      for (int q = 0; q < w.nci * w.ncs; ++q) {
        mbar_wait(empty + s, ph ^ 1);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(full + s, kSlice * (int)sizeof(bf16));
        const int2 b = slot_box<WN>(q, c0, w.nci, w.ncs);
        tma_box(buf + s * kSlice, &p.w, full + s, b.x, b.y);
        if (++s == a.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  }

  template <int WN>
  __device__ __forceinline__ const bf16* next(const Params&, const Walk&) {
    mbar_wait(full + slot, phase);
    return buf + slot * kSlice;
  }

  __device__ __forceinline__ void done(const Params& p) {
    __syncwarp();
    if (lane_id() == 0) mbar_arrive(empty + slot);
    if (++slot == p.a.stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};


// The WN warps of row group mi meet (named barrier 1 + mi).
template <int WN>
__device__ __forceinline__ void group_sync(int mi) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + mi), "r"(32 * WN) : "memory");
}

// acc[mt][nt] += A B^T over KS k-steps (4, or 2 in a half slice of K): A's
// fragments given for MT m-tiles, B the n-tiles n0 + 8 nt (NT of them) of a
// resident slot read as [n][k], loaded ahead of their products (NT = 1:
// two k-steps a ldmatrix); no branch inside, so that the loads run ahead.
template <int MT, int NT, int KS>
__device__ __forceinline__ void slot_mma(float (*acc)[NT][4],
                                         uint32_t (*af)[4][4],
                                         const bf16* sl, int n0) {
  const int lane = lane_id();
  if constexpr (NT == 1) {
    uint32_t b[KS / 2][4];
#pragma unroll
    for (int kp = 0; kp < KS / 2; ++kp)
      ldsm_x4(b[kp], sl + swz(n0 + (lane & 7), 32 * kp + (lane >> 3) * 8));
#pragma unroll
    for (int kp = 0; kp < KS / 2; ++kp)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16_16816(acc[mt][0], af[mt][2 * kp], b[kp][0], b[kp][1]);
        mma_bf16_16816(acc[mt][0], af[mt][2 * kp + 1], b[kp][2], b[kp][3]);
      }
  } else {
    // two k-steps' B fragments at a time
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += 2) {
      uint32_t b[2][NT / 2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int p = 0; p < NT / 2; ++p)
          ldsm_x4(b[k][p],
                  sl + swz(n0 + 16 * p + (lane & 7) + ((lane >> 4) << 3),
                           16 * (k0 + k) + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int p = 0; p < NT / 2; ++p)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[mt][2 * p], af[mt][k0 + k], b[k][p][0],
                           b[k][p][1]);
            mma_bf16_16816(acc[mt][2 * p + 1], af[mt][k0 + k], b[k][p][2],
                           b[k][p][3]);
          }
    }
  }
}

// Kernel 3's LayerNorm pass: statistics and bf16(ln) in x's place, in one
// pass: the warp's rows ni, ni + WN, .., RB at a time, a lane the 16-byte
// pieces lane + 32 u of each, held in registers (a piece that no lane of
// the warp holds is skipped as a whole).
template <int RW, int RB, int UR, int WN>
__device__ __forceinline__ void merge_ln(const Args& a, bf16* xt, int kp,
                                         int ni) {
  const int lane = lane_id(), K = a.K, P = K / 8;
#pragma unroll 1
  for (int r = ni; r < RW; r += RB * WN) {
    uint4 v[RB][UR];
    float mu[RB], inv[RB];
#pragma unroll
    for (int h = 0; h < RB; ++h) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int u = 0; u < UR; ++u) {
        if (32 * u >= P) break;
        const int pc = lane + 32 * u;
        v[h][u] = make_uint4(0u, 0u, 0u, 0u);
        if (pc < P)
          v[h][u] = *reinterpret_cast<const uint4*>(
              xt + tsw(r + WN * h, kp, 8 * pc));
        const uint32_t e[4] = {v[h][u].x, v[h][u].y, v[h][u].z, v[h][u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = unpack_bf2(e[j]);
          s += f.x + f.y;
          q += f.x * f.x + f.y * f.y;
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      mu[h] = s / K;
      inv[h] = rsqrtf(q / K - mu[h] * mu[h] + kEps);
    }
#pragma unroll
    for (int u = 0; u < UR; ++u) {
      if (32 * u >= P) break;
      const int pc = lane + 32 * u;
      if (pc >= P) continue;
      const uint4 gv = *reinterpret_cast<const uint4*>(a.gamma + 8 * pc);
      const uint4 bv = *reinterpret_cast<const uint4*>(a.beta + 8 * pc);
      const uint32_t ge[4] = {gv.x, gv.y, gv.z, gv.w};
      const uint32_t be[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int h = 0; h < RB; ++h) {
        uint32_t e[4] = {v[h][u].x, v[h][u].y, v[h][u].z, v[h][u].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = unpack_bf2(e[j]), gm = unpack_bf2(ge[j]),
                       bt = unpack_bf2(be[j]);
          e[j] = pack_bf2(ln_val(f.x, mu[h], inv[h], gm.x, bt.x),
                          ln_val(f.y, mu[h], inv[h], gm.y, bt.y));
        }
        *reinterpret_cast<uint4*>(xt + tsw(r + WN * h, kp, 8 * pc)) =
            make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
  }
}

// The task mode's LayerNorm pass: task t's rows row0 + r formed once, in
// fp32, in the order of the plain version (task_streams; the rank term
// summed over s in order, as 6b's dot8), from the shared rows, the rank
// rows of their tokens and Bs_t staged at bs, and kept in registers for
// the statistics and bf16(ln): the warp's rows ni, ni + WN, .., RB at a
// time, a lane the pieces lane + 32 u (u < UT) of each (dt, cb: their
// tokens from the row's first and columns of C). The loads of UC pieces of
// the RB rows are issued before the first is used; a row past M reads row
// M - 1, a piece past P piece P - 1, and both count as zero, so that no
// branch splits the loops. Bs_t lies in the tile's last two rows of the
// group: its warps meet before the last rows are written.
template <int RW, int RB, int UT, int UC, int WN>
__device__ __forceinline__ void task_ln(const Args& a, bf16* xt,
                                        const bf16* bs, int t, int row0,
                                        int mi, int ni, int kp,
                                        const int (&dt)[UT],
                                        const int (&cb)[UT]) {
  static_assert(UT % UC == 0, "the pieces, UC at a time");
  const int lane = lane_id(), K = a.K, C = a.C, M = a.M, P = K / 8;
  const bf16* mid = a.mid + (size_t)t * 4 * M * tmk::S;   // B L = 4 M tokens
  const float2* cf = reinterpret_cast<const float2*>(a.coef) + t * a.B;
#pragma unroll 1
  for (int r = ni; r < RW; r += RB * WN) {
    float y[RB][UT][8], s[RB], q[RB];
    float2 c[RB];
    int tok0[RB];
    bool in[RB];
#pragma unroll
    for (int h = 0; h < RB; ++h) {
      // the row's first token 2 (2 rr Wh + j), m = rr Wh + j, and its
      // sample's coefficients
      const int m = row0 + r + WN * h, mc = min(m, M - 1);
      in[h] = m < M;
      tok0[h] = 2 * (mc / a.Wh * a.Wh + mc);
      c[h] = cf[mc / a.per_sample];
      s[h] = q[h] = 0.f;
    }
#pragma unroll
    for (int u0 = 0; u0 < UT; u0 += UC) {
      // base, pre, p2 and the rank row of each piece
      uint4 v[RB][UC][4];
#pragma unroll
      for (int h = 0; h < RB; ++h)
#pragma unroll
        for (int j = 0; j < UC; ++j) {
          const int tok = tok0[h] + dt[u0 + j];
          const size_t o = (size_t)tok * C + cb[u0 + j];
          v[h][j][0] = tmk::ld16(a.x + o);
          v[h][j][1] = tmk::ld16(a.pre + o);
          v[h][j][2] = tmk::ld16(a.p2 + o);
          v[h][j][3] = tmk::ld16(mid + (size_t)tok * tmk::S);
        }
#pragma unroll
      for (int h = 0; h < RB; ++h)
#pragma unroll
        for (int j = 0; j < UC; ++j) {
          const int u = u0 + j, sw = cb[u] >> 3 & 7;
          const bool on = in[h] && lane + 32 * u < P;
          const uint32_t ev[4][4] = {
              {v[h][j][0].x, v[h][j][0].y, v[h][j][0].z, v[h][j][0].w},
              {v[h][j][1].x, v[h][j][1].y, v[h][j][1].z, v[h][j][1].w},
              {v[h][j][2].x, v[h][j][2].y, v[h][j][2].z, v[h][j][2].w},
              {v[h][j][3].x, v[h][j][3].y, v[h][j][3].z, v[h][j][3].w}};
          float mf[tmk::S];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = unpack_bf2(ev[3][e]);
            mf[2 * e] = f.x;
            mf[2 * e + 1] = f.y;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 b = unpack_bf2(ev[0][e]), pp = unpack_bf2(ev[1][e]),
                         qq = unpack_bf2(ev[2][e]);
            float uu[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const uint4 bv =
                  tmk::ld16(bs + tmk::S * (cb[u] + ((2 * e + i) ^ sw)));
              const uint32_t be[4] = {bv.x, bv.y, bv.z, bv.w};
              float acc = 0.f;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float2 f = unpack_bf2(be[k]);
                acc += mf[2 * k] * f.x;
                acc += mf[2 * k + 1] * f.y;
              }
              uu[i] = acc;
            }
            const float y0 = ((b.x + c[h].x * pp.x) + c[h].y * qq.x) + uu[0];
            const float y1 = ((b.y + c[h].x * pp.y) + c[h].y * qq.y) + uu[1];
            y[h][u][2 * e] = on ? y0 : 0.f;
            y[h][u][2 * e + 1] = on ? y1 : 0.f;
            s[h] += y[h][u][2 * e] + y[h][u][2 * e + 1];
            q[h] += y[h][u][2 * e] * y[h][u][2 * e] +
                    y[h][u][2 * e + 1] * y[h][u][2 * e + 1];
          }
        }
    }
    float mu[RB], inv[RB];
#pragma unroll
    for (int o = 16; o; o >>= 1)
#pragma unroll
      for (int h = 0; h < RB; ++h) {
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], o);
        q[h] += __shfl_xor_sync(0xffffffffu, q[h], o);
      }
#pragma unroll
    for (int h = 0; h < RB; ++h) {
      mu[h] = s[h] / K;
      inv[h] = rsqrtf(q[h] / K - mu[h] * mu[h] + kEps);
    }
    if (r + RB * WN >= RW) group_sync<WN>(mi);   // Bs_t is read
#pragma unroll
    for (int u = 0; u < UT; ++u) {
      const int pc = lane + 32 * u, pcc = min(pc, P - 1);
      const uint4 gv = *reinterpret_cast<const uint4*>(a.gamma + 8 * pcc);
      const uint4 bv = *reinterpret_cast<const uint4*>(a.beta + 8 * pcc);
      const uint32_t ge[4] = {gv.x, gv.y, gv.z, gv.w};
      const uint32_t be[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int h = 0; h < RB; ++h) {
        uint32_t e[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 gm = unpack_bf2(ge[j]), bt = unpack_bf2(be[j]);
          e[j] = pack_bf2(
              ln_val(y[h][u][2 * j], mu[h], inv[h], gm.x, bt.x),
              ln_val(y[h][u][2 * j + 1], mu[h], inv[h], gm.y, bt.y));
        }
        if (pc < P)
          *reinterpret_cast<uint4*>(xt + tsw(r + WN * h, kp, 8 * pc)) =
              make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
  }
}

// MT m-tiles of 16 rows a warp (32 rows; 16 at BM = 16), WN warps a row
// group: BM = 16 MT kWarps / WN rows a block; a warp takes 64 / WN columns
// of each chunk, NT = 8 / WN n-tiles. UT > 0: kernel 6's rows (the task
// mode, UT pieces of a row a lane), else kernel 3's.
template <int MT, int WN, int UT>
__device__ __forceinline__ void fwd_rows(const Params& p) {
  constexpr int RW = 16 * MT, NG = kWarps / WN, BM = RW * NG, NT = 8 / WN;
  constexpr bool TASK = UT > 0;
  // the LayerNorm pass: pieces of a row a lane, rows at a time
  constexpr int UR = ur_of(BM), RB = UR <= 6 ? 4 : 1;
  // the task mode's, whose rows' y a lane holds in fp32: rows at a time
  // (as many as 168 registers a thread hold), pieces whose loads are
  // issued together
  constexpr int RT = UT <= 2 ? 4 : UT <= 3 ? 2 : 1, UC = 1;
  constexpr int UA = TASK ? UT : 1;
  static_assert(NT >= 1 && 8 % WN == 0, "a warp's columns of a chunk");
  static_assert(RW % (RB * WN) == 0, "a warp's rows, RB at a time");
  static_assert(!TASK || RW % (RT * WN) == 0, "task rows, RT at a time");
  extern __shared__ __align__(1024) unsigned char smem[];
  const Args& a = p.a;
  const int K = a.K, M = a.M, O = a.O, C = a.C;
  const int kp = (K + kS - 1) / kS * kS;   // the tile's row length
  const Walk w(a);
  // Dynamic shared memory, from its first 1024-byte boundary (the
  // swizzle's period): the ring's slots; the bf16(ln) tile [BM][kp]; the
  // ring's full and empty mbarriers.
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  bf16* tile = reinterpret_cast<bf16*>(base) + a.stages * kSlice;
  uint64_t* bars = reinterpret_cast<uint64_t*>(tile + BM * kp);
  Ring ring(reinterpret_cast<bf16*>(base), bars, a.stages);
  // the plan's bytes (ops/ln_lora.py:merge_fwd_plan) must hold this layout
  if (ring.end(a.stages) - smem > (long)dynamic_smem_bytes() ||
      a.bm != BM || a.stages < 2 || a.group > kGroupMax ||
      a.stages % a.group || (TASK && (K / 8 > 32 * UT || UT != ut_of(BM, K))))
    __trap();
  if (threadIdx.x == 0) ring.init(a.stages);
  __syncthreads();   // the block's one barrier: the mbarriers are set
  const int warp = threadIdx.x >> 5;
  if (warp >= kWarps) {   // the producer warpgroup: its first warp issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == kWarps) ring.produce<WN>(p, w);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));

  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int mi = warp / WN, ni = warp % WN, wr = RW * mi;
  bf16* xt = tile + wr * kp;   // the row group's rows
  // The loader: thread tau of the row group copies pieces tau + 32 WN u
  // (16 bytes, columns 8 pc..) of each of its rows; d[u] is the piece's
  // offset in x from its merged row's base (run q = di + 2 dj of C).
  const int tau = lane + 32 * ni, P = K / 8;
  int d[kMaxU];
#pragma unroll
  for (int u = 0; u < kMaxU; ++u) {
    const int pc = tau + 32 * WN * u, k = 8 * min(pc, P - 1);
    const int q = k / C, c = k - q * C;
    d[u] = ((q & 1) * 2 * a.Wh + (q >> 1)) * C + c;
  }
  // the row group's rows of item `it` into its tile rows by cp.async, zero
  // past M (one division a row group and item; a row's base stepped)
  auto load_rows = [&](int it) {
    const int row0 = w.item(it) / a.splits * BM + wr;
    int rr = row0 / a.Wh, j = row0 - rr * a.Wh;
    for (int i = 0; i < RW; ++i) {
      const bool in = row0 + i < M;
      const bf16* src = a.x + (size_t)(4 * rr * a.Wh + 2 * j) * C;
#pragma unroll
      for (int u = 0; u < kMaxU; ++u) {
        const int pc = tau + 32 * WN * u;
        if (pc < P)
          cp_async16(xt + tsw(i, kp, 8 * pc), in ? src + d[u] : a.x, in);
      }
      if (++j == a.Wh) {
        j = 0;
        ++rr;
      }
    }
    cp_async_commit();
  };
  // The task mode: item `it`'s Bs_t [C][8] into the row group's last two
  // tile rows by cp.async, column c's 8 values at 16-byte position c ^
  // (c / 8 % 8). Its LayerNorm pass: lane pieces lane + 32 u of a row, at
  // dt[u] tokens from the row's first token and column cb[u] of C.
  bf16* bsg = xt + (RW - 2) * kp;
  auto load_bs = [&](int it) {
    const int tk = w.item(it) / a.splits % a.T;
    const bf16* src = a.bs + (size_t)tk * C * tmk::S;
    for (int c = tau; c < C; c += 32 * WN)
      cp_async16(bsg + tmk::S * (c ^ (c >> 3 & 7)), src + tmk::S * c, true);
    cp_async_commit();
  };
  int dt[UA], cb[UA];
#pragma unroll
  for (int u = 0; u < UA; ++u) {
    const int k = 8 * min(lane + 32 * u, P - 1), q = k / C;
    dt[u] = (q & 1) * 2 * a.Wh + (q >> 1);
    cb[u] = k - q * C;
  }
  auto load = [&](int it) {
    if constexpr (TASK)
      load_bs(it);
    else
      load_rows(it);
  };
  if (w.nitems > 0) load(0);

#pragma unroll 1
  for (int it = 0; it < w.nitems; ++it) {
    const int item = w.item(it);
    // the task mode's items: the T tasks of a row block, one after another
    const int rbt = item / a.splits, tk = TASK ? rbt % a.T : 0;
    const int row0 = (TASK ? rbt / a.T : rbt) * BM + wr;
    const int c0 = item % a.splits * w.nci;
    cp_async_wait<0>();
    group_sync<WN>(mi);   // the group's rows (or Bs_t) are in

    if constexpr (TASK)
      task_ln<RW, RT, UA, UC, WN>(a, xt, bsg, tk, row0, mi, ni, kp, dt, cb);
    else
      merge_ln<RW, RB, UR, WN>(a, xt, kp, ni);
    group_sync<WN>(mi);   // bf16(ln) whole

    // ---- passes of up to WN chunks: per slice of K the warp's A
    // fragments, then one slot a chunk; after the item's last products the
    // group's rows of the next item start loading, under the stores -------
#pragma unroll 1
    for (int c1 = 0; c1 < w.nci; c1 += WN) {
      const int live = min(WN, w.nci - c1);
      float acc[WN][MT][NT][4];
#pragma unroll
      for (int i = 0; i < WN; ++i)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) zero<NT>(acc[i][mt]);
      // one slice of K, KS k-steps: the A fragments, then the pass's slots
      auto slice = [&](auto ks_c, int cs) {
        constexpr int KS = decltype(ks_c)::value;
        uint32_t af[MT][4][4];
        const int lr = lane & 15, lc = kS * cs + (lane >> 4) * 8;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int k = 0; k < KS; ++k)
            ldsm_x4(af[mt][k], xt + tsw(16 * mt + lr, kp, lc + 16 * k));
#pragma unroll
        for (int i = 0; i < WN; ++i)
          if (i < live) {
            const bf16* sl = ring.next<WN>(p, w);
            slot_mma<MT, NT, KS>(acc[i], af, sl, (kS / WN) * ni);
            ring.done(p);
          }
      };
#pragma unroll 1
      for (int cs = 0; cs < w.ncs; ++cs) {
        if (ksteps(K, cs) == 4)
          slice(std::integral_constant<int, 4>(), cs);
        else
          slice(std::integral_constant<int, 2>(), cs);
      }
      if (c1 + WN >= w.nci) {   // the item's tile is read
        group_sync<WN>(mi);
        if (it + 1 < w.nitems) load(it + 1);
      }
      // y to its rows, 4 bytes a lane (rows past M, columns past O not)
#pragma unroll
      for (int i = 0; i < WN; ++i)
        if (i < live) {
          const int col0 = kS * (c0 + c1 + i) + (kS / WN) * ni + 2 * t;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + 16 * mt + g + 8 * h;
              if (row >= M) continue;
              bf16* out = a.y + ((size_t)tk * M + row) * O;
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                if (col0 + 8 * nt < O)
                  st_bf2(out + col0 + 8 * nt, acc[i][mt][nt][2 * h],
                         acc[i][mt][nt][2 * h + 1]);
            }
        }
    }
  }
}

// The two modes' kernels: their own symbols, so that a trace tells them
// apart (train/profile.py classifies kernels by name).
template <int MT, int WN>
__global__ void __launch_bounds__(kThreads, 1)
    patch_merge_fwd_rows(const __grid_constant__ Params p) {
  fwd_rows<MT, WN, 0>(p);
}

template <int MT, int WN, int UT>
__global__ void __launch_bounds__(kThreads, 1)
    task_merge_fwd_rows(const __grid_constant__ Params p) {
  fwd_rows<MT, WN, UT>(p);
}

template <int MT, int WN, int UT = 0>
cudaError_t launch(const Params& p, int blocks, int smem, cudaStream_t st) {
  const auto kern = [] {
    if constexpr (UT > 0)
      return task_merge_fwd_rows<MT, WN, UT>;
    else
      return patch_merge_fwd_rows<MT, WN>;
  }();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// Kernel 3: x the [.., H, W, C] stream gathered 2x2 (merge_wh = W / 2, M =
// L H / 2 W / 2 merged rows of K = 4C), wt = W [O, K] in its module layout,
// read in place by TMA; y [M, O]. C % 8 == 0 and K up to 4096, O % 16 ==
// 0. bm (128, 64, 32 or 16 rows a block), splits (the items of a row block,
// dividing its ceil(O / 64) chunks), blocks (at most the items: ceil(M /
// bm) splits, each block taking items in turn), the ring's stages and group
// and the shared-memory bytes smem are the caller's launch plan
// (ops/ln_lora.py:merge_fwd_plan); the kernel traps if smem does not hold
// its layout.
extern "C" int mtlora_merge_ln_fwd(const void* x, const void* gamma,
                                   const void* beta, const void* wt, void* y,
                                   int M, int C, int O, int merge_wh, int bm,
                                   int splits, int blocks, int stages,
                                   int group, int smem, void* stream) {
  const int K = 4 * C, nch = (O + kS - 1) / kS;
  const int wn = bm == 128 ? 2 : bm == 64 ? 4 : 8;
  const int items = (M + bm - 1) / bm * splits;
  if (M < 1 || C < 8 || C % 8 || K > kMaxK || O < 16 || O % 16 ||
      merge_wh < 1 || M % merge_wh ||
      !(bm == 128 || bm == 64 || bm == 32 || bm == 16) || splits < 1 ||
      nch % splits || K / 8 > kMaxU * 32 * wn || K / 8 > 32 * ur_of(bm) ||
      blocks < 1 ||
      blocks > items || group < 1 || group > kGroupMax || stages % group ||
      stages < 2 * group)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of x, TMA boxes of W, 16-byte reads of gamma and beta,
  // 4-byte stores of y
  if (misaligned(x) || misaligned(wt) || misaligned(gamma) ||
      misaligned(beta) || (uintptr_t)y % 4)
    return (int)cudaErrorMisalignedAddress;
  Params p{};
  Args& a = p.a;
  a.x = static_cast<const bf16*>(x);
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.y = static_cast<bf16*>(y);
  a.M = M;
  a.C = C;
  a.K = K;
  a.O = O;
  a.Wh = merge_wh;
  a.bm = bm;
  a.splits = splits;
  a.items = items;
  a.stages = stages;
  a.group = group;
  a.T = 1;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  if (!box_map(&p.w, wt, O, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bm == 128  ? launch<2, 2>(p, blocks, smem, st)
               : bm == 64 ? launch<2, 4>(p, blocks, smem, st)
               : bm == 32 ? launch<2, 8>(p, blocks, smem, st)
                          : launch<1, 8>(p, blocks, smem, st));
}

// Kernel 6, the task mode: base, pre, p2 [B*H*W, C] the shared rows; mid
// [T, B*H*W, 8] the rank rows, their coefficients folded in; bs_cs [T, C,
// 8] the scaled rank matrices (bf16); coef [T, B, 2] the drop-path
// coefficients (fp32); gamma, beta [4C]; wt = W [O, 4C] in its module
// layout -> y [T, B*H/2*W/2, O]. C % 16 == 0 and K = 4C up to kMaxKTask,
// O % 16 == 0, even H and W. bm (128, 64 or 32 rows a block), splits,
// blocks (at most the items: T ceil(M / bm) splits), stages, group and
// smem are the caller's launch plan (ops/task_merge.py:
// task_merge_fwd_plan, kernel 3's at those rows); the kernel traps if smem
// does not hold its layout.
extern "C" int mtlora_task_merge_fwd(const void* base, const void* pre,
                                     const void* p2, const void* mid,
                                     const void* bs_cs, const void* coef,
                                     const void* gamma, const void* beta,
                                     const void* wt, void* y, int T, int B,
                                     int H, int W, int C, int O, int bm,
                                     int splits, int blocks, int stages,
                                     int group, int smem, void* stream) {
  const int K = 4 * C, nch = (O + kS - 1) / kS;
  const int per_sample = (H / 2) * (W / 2), M = B * per_sample;
  const bool rows = bm == 128 || bm == 64 || bm == 32;
  const int items = rows ? (M + bm - 1) / bm * T * splits : 0;
  if (T < 1 || B < 1 || H < 2 || H % 2 || W < 2 || W % 2 || C < 16 ||
      C % 16 || K > kMaxKTask || O < 16 || O % 16 || !rows ||
      K / 8 > 32 * ut_of(bm, K) || splits < 1 || nch % splits ||
      blocks < 1 || blocks > items || group < 1 || group > kGroupMax ||
      stages % group || stages < 2 * group)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads of the shared and rank rows, copies of Bs, TMA boxes of
  // W, 16-byte reads of gamma and beta, 8-byte reads of the coefficients,
  // 4-byte stores of y
  if (misaligned(base) || misaligned(pre) || misaligned(p2) ||
      misaligned(mid) || misaligned(bs_cs) || (uintptr_t)coef % 8 ||
      misaligned(wt) || misaligned(gamma) || misaligned(beta) ||
      (uintptr_t)y % 4)
    return (int)cudaErrorMisalignedAddress;
  Params p{};
  Args& a = p.a;
  a.x = static_cast<const bf16*>(base);
  a.pre = static_cast<const bf16*>(pre);
  a.p2 = static_cast<const bf16*>(p2);
  a.mid = static_cast<const bf16*>(mid);
  a.bs = static_cast<const bf16*>(bs_cs);
  a.coef = static_cast<const float*>(coef);
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.y = static_cast<bf16*>(y);
  a.M = M;
  a.C = C;
  a.K = K;
  a.O = O;
  a.Wh = W / 2;
  a.bm = bm;
  a.splits = splits;
  a.items = items;
  a.stages = stages;
  a.group = group;
  a.T = T;
  a.B = B;
  a.per_sample = per_sample;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  if (!box_map(&p.w, wt, O, K)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ut = ut_of(bm, K);
  return (int)(ut == 2   ? launch<2, 2, 2>(p, blocks, smem, st)
               : ut == 3 ? launch<2, 2, 3>(p, blocks, smem, st)
               : ut == 4 ? launch<2, 4, 4>(p, blocks, smem, st)
               : ut == 6 ? launch<2, 4, 6>(p, blocks, smem, st)
                         : launch<2, 8, 8>(p, blocks, smem, st));
}
