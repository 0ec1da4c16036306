// Fused LayerNorm + frozen GEMM + shared LoRA (forward) for Hopper, in two
// compile-time modes of one kernel body:
//   ln = LN(x)                        fp32 statistics, var = E[x^2] - mu^2
//   p  = bf16(ln) W^T + b             fp32 accumulate, bf16 bias
//   m  = bf16(bf16(drop0(ln)) A^T)    shared adapter, rank r <= 64
//   z  = p + s m B^T
// The qkv mode (ln_lora_qkv_fwd_kernel, kernel 2 at norm1 -> qkv of every
// block) writes y = bf16(z) alone. The stage-tail mode
// (ln_lora_tail_fwd_kernel, norm2 -> fc1 of the four blocks that carry
// task streams) writes y = bf16(gelu(z)) in the tanh form (lnk::kGelu; z
// without act), p as bf16(p) and, in training, d = bf16(drop1(gelu(z))) on
// hash stream 1 (the next layer's pre-dropped adapter input). Their
// backwards are ln_lora_qkv_bwd.cu and ln_lora_tail_bwd.cu.
//
// Replaces mtlora_tpu/ops/pallas_ln_lora.py: _fwd_kernel (:74), launched
// by _run_fwd (:270, call :303) through fused_ln_lora_linear, with out_p,
// out_act and out_drop all False (the qkv mode) and with them (:106-118,
// the tail mode).
//
// What bounds it: a row of C inputs makes O = 3C outputs (the qkv mode)
// or three rows of O = 4C (the tail mode), 2 M (C O + C r + r O) FLOP for
// 2 M (C + O) or 2 M (C + 3 O) bytes: 87-768 FLOP a byte, about the
// card's ~295 ridge. The output bytes bound the narrow stages and the
// products the wide ones; beside them, the epilogue of every output
// element (in the tail mode its GELU and, in training, the mask hash: 19
// dependent integer steps). The first ports (4 warps on 16 rows, the
// weights read from L2 inside the MMA loop, 4-byte stores from the
// fragment layout, output chunks round robin over the warps) reached 9%
// (tail) and 5% (qkv) of the bound. In the qkv mode the products take a
// fifth to a quarter of the time and the ring's delivery of its slots most
// of the rest: a group each 2-3 thousand cycles an SM whatever its size
// or the ring's depth, and no faster with the slots multicast to two
// blocks of a cluster (PERF.md §6). Design:
//   - a block of 8 warps; a warp owns 16 rows and one 64-column output
//     chunk at a time, the WN warps of a row group taking WN chunks side by
//     side: WN = 1 (128 rows a block) up to C = 384, WN = 2 (64 rows) above,
//     where the bf16(ln) tile, rows x C, would take most of the shared
//     memory. Every warp carries the same share of the columns at every
//     width. An item is a row block and one split of its chunks (split
//     where the row blocks are few); the blocks are persistent and take the
//     items in turn. Two blocks an SM where shared memory allows them a
//     ring of 4 slots or more (WN = 1, C up to 192: stages 0 and 1), at
//     most 128 registers a thread and one staging tile a warp: the second
//     block's warps hide the first's latencies, which 8 warps could not
//     (the variant tail-fwd-one-block-an-sm, PERF.md §6). The launch plan
//     (ops/ln_lora.py:tail_fwd_plan, qkv_fwd_plan) owns rows, splits,
//     blocks an SM, ring depth and shared-memory bytes; the kernel traps if
//     the bytes do not hold its layout; the last row block masks its rows
//     past M;
//   - a row group works on its own: it loads its rows of x by cp.async,
//     takes their statistics (in registers), m = bf16(bf16(drop0(ln)) A^T)
//     (its WN warps take A's slices in turn and sum their shares, so that
//     each element of ln is hashed once) and writes bf16(ln) in x's place,
//     meeting only its WN warps, while the other groups multiply and store
//     (with block barriers every warp of the block waited on it). m stays
//     in registers as the A fragments of the u products;
//   - A, then per chunk W's ceil(C / 64) slices and B stream through a
//     ring of 64 x 64 slots by TMA (128-byte swizzle, zero outside the
//     arrays, so that a rank r < 64 reads as zero past r; one mbarrier a
//     group of slots, whose boxes the lanes of one warp start at once), in
//     their module layouts (wt [O, C], at [r, C], bt [O, r]): each staged
//     weight byte serves the block's rows. The warps walk the ring without
//     block barriers, the last warp done with a group refilling it, so that
//     they drift apart by up to the ring's depth;
//   - the products: mma.sync m16n8k16 on ldmatrix fragments. The u
//     products accumulate onto p / s and z = s (p / s + m B^T), so that u
//     takes no registers of its own; in the tail mode p, staged first,
//     goes to its rows meanwhile;
//   - the epilogue, one output at a time: the warp rounds its 16 x 64 tile
//     to bf16 into a staging tile of its own (stmatrix) and writes it out
//     as whole 128-byte row segments, 16 bytes a lane (st.global.v4); the
//     stores drain while the warp goes on. With two staging tiles a warp
//     (the tail mode at one block an SM) the next output takes the other
//     while the lanes' reads of the last finish; the qkv mode, one output a
//     chunk, stages in one (two where WN = 2: m's shares) and gives the
//     shared memory it saves to the ring. The GELU is z sigma(2u), u =
//     z (c + c d z^2): the tanh form's 0.5 z (1 + tanh u), by ex2.approx
//     and a fast divide (within about 1e-7 of tanhf's, as the backward's
//     gelu'). The masks are the hashes of dropout.cuh, bit for bit. The
//     epilogue's loops hold no branch (act, the streams and the mode are
//     decided outside them): a branch per element had cut them into blocks
//     of one or two chains each, the GELU and the hashes waiting on one
//     dependent step after another.

#include "tma.cuh"

namespace {

using namespace lnk;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kS = 64;               // a slot and an output chunk: 64 wide
constexpr int kLdS = kS + 8;         // row stride of the staging tiles
constexpr int kSlice = kS * kS;      // elements of a slot
constexpr int kRank = 64;            // the rank's slot (r <= 64)
constexpr int kGroupMax = 4;         // slots a ring group
constexpr int kWide = 384;           // C above which WN = 2
static_assert(kS == kSliceW, "slice_ring.cuh: ksteps");
static_assert(kGelu == Act::Tanh, "gelu_tanh is the tanh form");

// The weights as TMA tensor maps: [rows][cols] bf16, boxes of 64 x 64,
// 128-byte swizzle.
enum { kW, kA, kB, kMaps };

struct Args {
  const bf16 *x, *gamma, *beta, *bias;
  bf16 *y, *p, *d;    // p null in the qkv mode; d may be null
  int M, C, O, r, act;
  int wn;             // warps on the same 16 rows (chunks side by side)
  int splits;         // items of a row block, splitting its super-chunks
  int per_split;      // super-chunks of an item
  int items;          // row blocks x splits
  int stages, group;  // ring slots and slots a group
  float s;
  DropSpec d0, d1;
};

struct Params {
  Args a;
  CUtensorMap maps[kMaps];
};

struct Box {
  int map, c0, r0;
};

// Slots an item multiplies with (ncs slices of 64 columns of C): A for m,
// then per super-chunk W's slice cs of each of its wn chunks, cs = 0 ..
// ncs - 1, and B of each.
__device__ __forceinline__ int item_slots(const Args& a, int ncs) {
  return ncs + a.per_split * a.wn * (ncs + 1);
}

// The q-th slot of a block, whose k-th item is blockIdx.x + k gridDim.x.
__device__ __forceinline__ Box box_of(const Args& a, int q, int ncs) {
  const int per_item = item_slots(a, ncs), k = q / per_item;
  q -= k * per_item;
  if (q < ncs) return Box{kA, kS * q, 0};                          // m
  q -= ncs;
  const int item = (int)blockIdx.x + k * (int)gridDim.x;
  const int per = a.wn * (ncs + 1), j = q / per;
  const int chunk = (item % a.splits * a.per_split + j) * a.wn;
  const int i = q - j * per;
  if (i < a.wn * ncs)
    return Box{kW, kS * (i / a.wn), kS * (chunk + i % a.wn)};      // p
  return Box{kB, 0, kS * (chunk + i - a.wn * ncs)};                // u
}

// The ring of slots of a block: a.stages slots in groups of a.group, one
// mbarrier a group that its boxes complete, and one count a group of the
// warps done with its slots. The warps walk the ring on their own, with no
// block barrier: every warp calls next() at the same points of its own
// walk, and slot q is resident when next() returns it. Where q starts a
// group, next() first hands back the warp's group before: the last of the
// kWarps warps to hand a group back starts the group nbar ahead into its
// slots, which no warp reads any more. Then it waits on q's group's
// mbarrier. So the warps drift apart by up to nbar - 1 groups, and one
// warp's products overlap another's epilogue and stores.
struct Ring {
  bf16* buf;       // 1024-byte aligned
  uint64_t* bars;  // stages / group
  int* held;       // stages / group: the warps' hand-backs, counted up
  int total, ncs, nbar;
  int g = 0, qg = 0, slot = 0;   // group, slot in the group, ring slot

  // The calling warp starts group gi: lane k box k, all at once, lane 0
  // first posting the group's bytes on its mbarrier.
  __device__ __forceinline__ void issue(const Params& p, int gi) {
    const Args& a = p.a;
    const int first = gi * a.group, n = min(a.group, total - first);
    if (n <= 0) return;
    const int k = lane_id();
    uint64_t* bar = bars + gi % nbar;
    if (k == 0) mbar_expect(bar, n * kSlice * (int)sizeof(bf16));
    __syncwarp();
    if (k < n) {
      const Box b = box_of(a, first + k, ncs);
      tma_box(buf + ((first + k) % a.stages) * kSlice, &p.maps[b.map], bar,
              b.c0, b.r0);
    }
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

// The WN warps of row group mi meet (named barrier 1 + mi); a warp alone
// only reconverges.
template <int WN>
__device__ __forceinline__ void group_sync(int mi) {
  if constexpr (WN == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + mi), "r"(32 * WN)
                 : "memory");
}

// fmix32 of dropout.cuh on N values, step by step across them.
template <int N>
__device__ __forceinline__ void fmix_n(uint32_t* x) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] ^= x[j] >> 16;
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] *= 0x85EBCA6Bu;
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] ^= x[j] >> 13;
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] *= 0xC2B2AE35u;
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] ^= x[j] >> 16;
}

// v[j] = drop(v[j]) by the mask of dropout.cuh at element idx[j] of a
// stream that is on (row * cols + col, mod 2^32). The N hashes, each a
// chain of 19 dependent instructions, go step by step across the N: one
// after another, as ptxas ordered them, they left the integer pipe idle
// between dependent steps.
template <int N>
__device__ __forceinline__ void drop_n(const Drop& d, const uint32_t* idx,
                                       float* v) {
  uint32_t x[N];
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = idx[j] ^ d.key;
  fmix_n<N>(x);
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] += d.key;
  fmix_n<N>(x);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = x[j] >= d.thr ? v[j] * d.inv_keep : 0.f;
}

// Mean and 1/sqrt(var + eps) of the lane's rows g and g + 8 (h = 0, 1) of
// a warp's 16 rows of x, staged in `xt` (row stride ld), in fp32 as
// rows_stats computes them: the 4 lanes of a row sum its pairs at columns
// 2 t + 8 j, then a shuffle sum; rows past M (valid of the 16) get 0, 0.
__device__ __forceinline__ void quad_stats(const bf16* xt, int ld, int C,
                                           int valid, float* mu,
                                           float* inv) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bf16* row = xt + (g + 8 * h) * ld + 2 * t;
    float s = 0.f, q = 0.f;
    for (int c = 0; c < C; c += 8) {
      const float2 v = bf2(row + c);
      s += v.x + v.y;
      q += v.x * v.x + v.y * v.y;
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    const float mean = s / C;
    const bool in = g + 8 * h < valid;
    mu[h] = in ? mean : 0.f;
    inv[h] = in ? rsqrtf(q / C - mean * mean + kEps) : 0.f;
  }
}

// A fragments of bf16(drop0(ln)) (DROP: stream 0 on) for a warp's 16
// rows (the first row m0 of x [M, C], staged at `xt`, row stride ld) and
// the 16 ks columns from c0, with the lane's rows' statistics; zero past M
// (in[h]: the lane's row g + 8 h is one of x's).
template <bool DROP>
__device__ __forceinline__ void lnd_frags(uint32_t (*af)[4], const bf16* xt,
                                          int ld, const bf16* gs,
                                          const bf16* bs, int m0,
                                          const bool* in, int C, int c0,
                                          int ks, const float* mu,
                                          const float* inv, const Drop& d) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < kS / 16; ++k)
    if (k < ks) {
      float v[8];
      uint32_t idx[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e & 1, i = g + 8 * h;
        const int c = c0 + 16 * k + 2 * t + 8 * (e >> 1);
        const float2 x2 = bf2(xt + i * ld + c), gm = bf2(gs + c),
                     be = bf2(bs + c);
        v[2 * e] = ln_val(x2.x, mu[h], inv[h], gm.x, be.x);
        v[2 * e + 1] = ln_val(x2.y, mu[h], inv[h], gm.y, be.y);
        idx[2 * e] = (uint32_t)(m0 + i) * C + c;
        idx[2 * e + 1] = idx[2 * e] + 1;
      }
      if constexpr (DROP) drop_n<8>(d, idx, v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        af[k][e] = in[e & 1] ? pack_bf2(v[2 * e], v[2 * e + 1]) : 0u;
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

// The tanh form of GELU, 0.5 z (1 + tanh u) = z sigma(2u) = z / (1 +
// 2^(-2 log2(e) u)): ex2.approx.ftz and a fast divide (1 + e >= 1).
__device__ __forceinline__ float gelu_tanh(float z) {
  const float u = z * (kGeluC + kGeluCD * (z * z));
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(e)
      : "f"(u * -2.8853900817779268f));
  return __fdividef(z, 1.f + e);
}

// n-tiles nt and nt + 1 of a warp's 16 x 64 tile, as bf16 pairs in the
// accumulator layout (v[i][h]: n-tile nt + i, rows 8 h + g), into its
// staging tile [16][72]: one stmatrix of the four 8 x 8 blocks, lane l
// giving the row address of row l % 8 of block l / 8.
__device__ __forceinline__ void stage4(bf16* sb, int nt,
                                       const uint32_t (*v)[2]) {
  const int lane = lane_id(), q = lane >> 3;
  const bf16* row =
      sb + (8 * (q & 1) + (lane & 7)) * kLdS + 8 * (nt + (q >> 1));
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(smem_u32(row)),
      "r"(v[0][0]), "r"(v[0][1]), "r"(v[1][0]), "r"(v[1][1])
      : "memory");
}

// A warp's 16 x 64 fp32 tile, rounded to bf16, into its staging tile.
__device__ __forceinline__ void stage_tile(bf16* sb, const float (*c)[4]) {
#pragma unroll
  for (int nt = 0; nt < 8; nt += 2) {
    uint32_t v[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[i][h] = pack_bf2(c[nt + i][2 * h], c[nt + i][2 * h + 1]);
    stage4(sb, nt, v);
  }
}

// c += the bias of columns n0.. (zero past O).
__device__ __forceinline__ void add_bias(float (*c)[4], const bf16* bias,
                                         int n0, int O) {
  const int t = lane_id() & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = n0 + 8 * nt + 2 * t;
    const float2 b = col < O ? bf2(bias + col) : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      c[nt][2 * h] += b.x;
      c[nt][2 * h + 1] += b.y;
    }
  }
}

// The warp's staging tile (its rows row0.., columns n0..) to out [M, O]:
// lane l moves 16 bytes of row l / 8 + 4 k, so that 8 lanes write a row's
// whole 128-byte segment; rows past M and columns past O are not written
// (checked only in a tile at the edge). With one staging tile (NBUF 1)
// the lanes meet again before the next output takes it.
template <int NBUF>
__device__ __forceinline__ void tile_out(bf16* out, const bf16* sb, int row0,
                                         int n0, int M, int O) {
  __syncwarp();   // the lanes' blocks are in the tile
  const int lane = lane_id(), c = 8 * (lane & 7), i0 = lane >> 3;
  const bool whole = row0 + kRows <= M && n0 + kS <= O;
  bf16* o = out + (size_t)(row0 + i0) * O + n0 + c;
  const size_t step = (size_t)4 * O;
#pragma unroll
  for (int k = 0; k < kRows / 4; ++k, o += step)
    if (whole || (row0 + i0 + 4 * k < M && n0 + c < O))
      *reinterpret_cast<uint4*>(o) =
          *reinterpret_cast<const uint4*>(sb + (i0 + 4 * k) * kLdS + c);
  if (NBUF == 1) __syncwarp();
}

// The body of both modes (TAIL: the stage-tail mode, else the qkv mode).
// PER_SM blocks an SM, persistent: a block takes items blockIdx.x, +
// gridDim.x, .. (an item: the BM rows of a row block and one split of its
// super-chunks). Its row groups (WN warps on 16 rows) work on their own: a
// group loads and normalises its rows of the next item while the others
// multiply and store, meeting only its own WN warps; the warps of the
// block share only the ring. Two blocks an SM (at most 128 registers a
// thread, one staging tile a warp) overlap one's phases with the other's
// where a block's shared memory allows it.
template <int WN, int PER_SM, bool TAIL>
__device__ __forceinline__ void fwd_body(const Params& p) {
  constexpr int BM = kRows * kWarps / WN;
  // staging tiles a warp: the tail mode's three outputs take turns in two
  // where one block an SM leaves room; y alone needs one, m's shares two
  constexpr int NBUF = TAIL ? 3 - PER_SM : WN;
  static_assert(NBUF == 2 || WN == 1, "m's shares take two staging tiles");
  extern __shared__ __align__(1024) unsigned char smem[];
  const Args& a = p.a;
  const int C = a.C, M = a.M, O = a.O, ld = C + 8;
  const int ncs = (C + kS - 1) / kS;
  const int warp = threadIdx.x >> 5, lane = lane_id(), g = lane >> 2,
            t = lane & 3;
  const int mi = warp / WN, ni = warp % WN, wr = kRows * mi;
  const int nitems = (a.items - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x;
  // Dynamic shared memory, from its first 1024-byte boundary (the
  // swizzle's period): the ring; the tile of x, then bf16(ln) [BM][C + 8]
  // (row group mi's rows 16 mi..); gamma and beta [C]; NBUF staging tiles
  // [16][72] a warp (bf16; two hold first its share of m, fp32); the ring's
  // mbarriers and counts. The padded row strides keep ldmatrix, the
  // statistics and the staging free of bank conflicts.
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  bf16* lt = reinterpret_cast<bf16*>(base) + a.stages * kSlice;
  bf16* gs = lt + BM * ld;
  bf16* bs = gs + C;
  bf16* stg = bs + C;
  const int nbar = a.stages / a.group;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(stg + kWarps * NBUF * kRows * kLdS);
  Ring ring{reinterpret_cast<bf16*>(base), bars,
            reinterpret_cast<int*>(bars + nbar),
            nitems * item_slots(a, ncs), ncs, nbar};
  // the plan's bytes (ops/ln_lora.py:_fwd_plan) must hold this layout
  if (reinterpret_cast<unsigned char*>(ring.held + nbar) - smem >
          dynamic_smem_bytes() ||
      a.group > kGroupMax || nbar < 2 || a.wn != WN)
    __trap();

  for (int v = threadIdx.x; v < C / 8; v += kThreads) {
    cp_async16(gs + 8 * v, a.gamma + 8 * v, true);
    cp_async16(bs + 8 * v, a.beta + 8 * v, true);
  }
  cp_async_commit();
  ring.start(p);
  cp_async_wait<0>();
  __syncthreads();   // gamma, beta and the ring's mbarriers are set
  const Drop d0 = make_drop(a.d0), d1 = make_drop(a.d1);
  bf16* xt = lt + wr * ld;                    // the row group's rows
  bf16* sb = stg + warp * NBUF * kRows * kLdS;  // the warp's staging tiles
  // (a warp's two staging tiles hold kRows * kLdS fp32)
  float* share = reinterpret_cast<float*>(sb);
  int buf = 0;   // the staging tile of the next output (NBUF 2)
  const float s = a.s, inv_s = s != 0.f ? 1.f / s : 0.f;

#pragma unroll 1
  for (int k = 0; k < nitems; ++k) {
    const int item = (int)blockIdx.x + k * (int)gridDim.x;
    const int m0 = item / a.splits * BM, row0 = m0 + wr;
    const int j0 = item % a.splits * a.per_split;
    const int valid = min(kRows, M - row0);   // the group's rows in x

    // ---- the row group's rows of x (zero past M), their statistics ------
    group_sync<WN>(mi);   // the group is done with its rows of the last
    for (int v = lane + 32 * ni; v < kRows * (C / 8); v += 32 * WN) {
      const int i = v / (C / 8), c = 8 * (v - i * (C / 8));
      const bool own = i < valid;
      cp_async16(xt + i * ld + c, own ? a.x + (size_t)(row0 + i) * C + c : a.x,
                 own);
    }
    cp_async_commit();
    cp_async_wait<0>();
    group_sync<WN>(mi);
    float mu[2], inv[2];
    quad_stats(xt, ld, C, valid, mu, inv);
    const bool in[2] = {g < valid, g + 8 < valid};

    // ---- m = bf16(bf16(drop0(ln)) A^T) for the 16 rows, all 64 columns,
    // as A fragments: the WN warps take A's slices in turn and sum their
    // shares in warp order through their staging tiles -------------------
    uint32_t mf[4][4];
    {
      float acc[8][4];
      zero<8>(acc);
#pragma unroll 1
      for (int cs = 0; cs < ncs; ++cs) {
        const bf16* sl = ring.next(p);
        if (cs % WN != ni) continue;
        const int ks = ksteps(C, cs);
        uint32_t af[4][4];
        if (d0.on)
          lnd_frags<true>(af, xt, ld, gs, bs, row0, in, C, kS * cs, ks, mu,
                          inv, d0);
        else
          lnd_frags<false>(af, xt, ld, gs, bs, row0, in, C, kS * cs, ks, mu,
                           inv, d0);
        mma_slot<8>(acc, af, sl, 0, ks);
      }
      if constexpr (WN > 1) store_frag(share + lane * 4, acc);
      group_sync<WN>(mi);   // x is read, the shares are left
      if constexpr (WN > 1) {
        zero<8>(acc);
#pragma unroll
        for (int w = 0; w < WN; ++w) {
          float sh[8][4];
          load_frag(sh, share + (w - ni) * kRows * kLdS + lane * 4);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] += sh[nt][e];
        }
      }
      pack_frags(mf, acc);
    }
    // ---- bf16(ln) in x's place (zero past M): the WN warps split the
    // columns -----------------------------------------------------------
    {
      const int cw = C / WN, c0 = cw * ni;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* row = xt + (g + 8 * h) * ld;
        for (int c = c0 + 2 * t; c < c0 + cw; c += 8) {
          const float2 x2 = bf2(row + c), gm = bf2(gs + c), be = bf2(bs + c);
          st_bf2(row + c,
                 in[h] ? ln_val(x2.x, mu[h], inv[h], gm.x, be.x) : 0.f,
                 in[h] ? ln_val(x2.y, mu[h], inv[h], gm.y, be.y) : 0.f);
        }
      }
    }
    group_sync<WN>(mi);   // bf16(ln) whole; the shares are read

    // ---- the item's super-chunks: WN chunks of 64 columns, one a warp ---
#pragma unroll 1
    for (int j = 0; j < a.per_split; ++j) {
      const int n0 = kS * ((j0 + j) * WN + ni);
      float pc[8][4];
      zero<8>(pc);
      // p = bf16(ln) W^T, slice by slice as they arrive
#pragma unroll 1
      for (int cs = 0; cs < ncs; ++cs) {
        const int ks = ksteps(C, cs);
        uint32_t af[4][4];
        a_frags(af, xt + kS * cs, ld, ks);
#pragma unroll
        for (int i = 0; i < WN; ++i) {
          const bf16* sl = ring.next(p);
          if (i == ni) mma_slot<8>(pc, af, sl, 0, ks);
        }
      }
      const bool live = n0 < O;   // false past the last chunk (WN = 2)

      // p = acc + b, staged in the tail mode
      add_bias(pc, a.bias, n0, O);
      bf16* tb = sb + (NBUF == 2 ? buf : 0) * kRows * kLdS;
      if (TAIL && live) stage_tile(tb, pc);
      // z = p + s m B^T as s (p / s + m B^T): the u products accumulate
      // onto p / s, so that u takes no registers of its own (s = 0: z =
      // p); p goes to its rows while they run
      if (s != 0.f)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pc[nt][e] *= inv_s;
#pragma unroll
      for (int i = 0; i < WN; ++i) {
        const bf16* sl = ring.next(p);
        if (i == ni && s != 0.f) mma_slot<8>(pc, mf, sl, 0, 4);
      }
      if (!live) continue;
      if constexpr (TAIL) {
        tile_out<NBUF>(a.p, tb, row0, n0, M, O);
        buf ^= 1;
      }
      // y = gelu(z) (z without act) to its rows, kept in fp32 for d (the
      // branches outside the loops: their 32 elements interleave)
      if (s != 0.f)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pc[nt][e] *= s;
      if (TAIL && a.act)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) pc[nt][e] = gelu_tanh(pc[nt][e]);
      tb = sb + (NBUF == 2 ? buf : 0) * kRows * kLdS;
      stage_tile(tb, pc);
      tile_out<NBUF>(a.y, tb, row0, n0, M, O);
      buf ^= 1;
      // d = drop1(y) to its rows (d is written only with stream 1 on):
      // element (m, col) of [M, O] is hashed at m O + col
      if (TAIL && a.d) {
        tb = sb + (NBUF == 2 ? buf : 0) * kRows * kLdS;
        const uint32_t e0 = (uint32_t)(row0 + g) * O + n0 + 2 * t;
        const uint32_t e1 = e0 + 8 * (uint32_t)O;
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          float dv[8];
          uint32_t idx[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int i = j >> 2, h = (j >> 1) & 1, e = j & 1;
            dv[j] = pc[nt + i][2 * h + e];
            idx[j] = (h ? e1 : e0) + 8 * (nt + i) + e;
          }
          drop_n<8>(d1, idx, dv);
          uint32_t v[2][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              v[i][h] = pack_bf2(dv[4 * i + 2 * h], dv[4 * i + 2 * h + 1]);
          stage4(tb, nt, v);
        }
        tile_out<NBUF>(a.d, tb, row0, n0, M, O);
        buf ^= 1;
      }
    }
  }
}

// The two modes' kernels: their own symbols, so that a trace tells them
// apart (train/profile.py classifies kernels by name).
template <int WN, int PER_SM>
__global__ void __launch_bounds__(kThreads, PER_SM)
    ln_lora_tail_fwd_kernel(const __grid_constant__ Params p) {
  fwd_body<WN, PER_SM, true>(p);
}

template <int WN, int PER_SM>
__global__ void __launch_bounds__(kThreads, PER_SM)
    ln_lora_qkv_fwd_kernel(const __grid_constant__ Params p) {
  fwd_body<WN, PER_SM, false>(p);
}

template <int WN, int PER_SM>
cudaError_t launch(const Params& p, bool tail, int blocks, int smem,
                   cudaStream_t st) {
  auto kern = tail ? ln_lora_tail_fwd_kernel<WN, PER_SM>
                   : ln_lora_qkv_fwd_kernel<WN, PER_SM>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

// The checks and the launch of either mode (p null: the qkv mode).
int run(const void* x, const void* gamma, const void* beta, const void* wt,
        const void* bias, const void* at, const void* bt, const void* seed,
        void* y, void* p, void* d, int M, int C, int O, int r, int act,
        int bm, int splits, int per_sm, int blocks, int stages, int group,
        int smem, float scale, unsigned thr, int use_drop, float inv_keep,
        void* stream) {
  const int wn = C <= kWide ? 1 : 2;
  const int nsc = ((O + kS - 1) / kS + wn - 1) / wn;
  const int items = (M + bm - 1) / bm * splits;
  if (M < 1 || C < 16 || C % 16 || C > 1024 || O < 8 || O % 8 || r < 16 ||
      r % 16 || r > kRank || bm != kRows * kWarps / wn || splits < 1 ||
      nsc % splits || !(per_sm == 1 || (per_sm == 2 && wn == 1)) ||
      blocks < 1 || blocks > items || group < 1 ||
      group > kGroupMax || stages % group || stages < 2 * group ||
      (!p && (d || act)) || (d && !use_drop))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies of x, gamma, beta and stores of the outputs, TMA boxes
  // of the weights
  if (misaligned(x) || misaligned(gamma) || misaligned(beta) ||
      misaligned(wt) || misaligned(at) || misaligned(bt) || misaligned(y) ||
      (p && misaligned(p)) || (d && misaligned(d)))
    return (int)cudaErrorMisalignedAddress;
  Params pr;
  Args& a = pr.a;
  a.x = static_cast<const bf16*>(x);
  a.gamma = static_cast<const bf16*>(gamma);
  a.beta = static_cast<const bf16*>(beta);
  a.bias = static_cast<const bf16*>(bias);
  a.y = static_cast<bf16*>(y);
  a.p = static_cast<bf16*>(p);
  a.d = static_cast<bf16*>(d);
  a.M = M;
  a.C = C;
  a.O = O;
  a.r = r;
  a.act = act;
  a.wn = wn;
  a.splits = splits;
  a.per_split = nsc / splits;
  a.items = items;
  a.stages = stages;
  a.group = group;
  a.s = scale;
  for (int s = 0; s < 2; ++s) {
    DropSpec& ds = s ? a.d1 : a.d0;
    ds.seed = static_cast<const int*>(seed);
    ds.stream = s;
    ds.on = use_drop;
    ds.thr = thr;
    ds.inv_keep = inv_keep;
  }
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  if (!box_map(&pr.maps[kW], wt, O, C) || !box_map(&pr.maps[kA], at, r, C) ||
      !box_map(&pr.maps[kB], bt, O, r))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tail = p != nullptr;
  return (int)(wn == 2        ? launch<2, 1>(pr, tail, blocks, smem, st)
               : per_sm == 1 ? launch<1, 1>(pr, tail, blocks, smem, st)
                             : launch<1, 2>(pr, tail, blocks, smem, st));
}

}  // namespace

// The tail mode: x [M, C] -> y = bf16(gelu(z)) [M, O] (z without act), p =
// bf16(LN(x) W^T + b) and d = bf16(drop1(y)) [M, O] (d may be null; d needs
// use_drop). Weights in the module layouts, read in place by TMA: wt [O, C],
// at [r, C], bt [O, r]; bf16 gamma, beta, bias. C % 16 == 0 up to 1024, O %
// 8 == 0, r 16, 32, 48 or 64. bm (128 up to C = 384, WN = 1; else 64, WN =
// 2), splits (the items of a row block, dividing its ceil(ceil(O / 64) /
// WN) super-chunks), per_sm (the blocks an SM: 1, or 2 with WN = 1),
// blocks (at most the items: ceil(M / bm) splits), the ring's stages and
// group, and the shared-memory bytes smem are the caller's launch plan
// (ops/ln_lora.py:tail_fwd_plan); the kernel traps if smem does not hold
// its layout. use_drop: both hash streams at threshold thr.
extern "C" int mtlora_ln_lora_tail_fwd(
    const void* x, const void* gamma, const void* beta, const void* wt,
    const void* bias, const void* at, const void* bt, const void* seed,
    void* y, void* p, void* d, int M, int C, int O, int r, int act, int bm,
    int splits, int per_sm, int blocks, int stages, int group, int smem,
    float scale, unsigned thr, int use_drop, float inv_keep, void* stream) {
  if (!p) return (int)cudaErrorInvalidValue;
  return run(x, gamma, beta, wt, bias, at, bt, seed, y, p, d, M, C, O, r,
             act, bm, splits, per_sm, blocks, stages, group, smem, scale,
             thr, use_drop, inv_keep, stream);
}

// The qkv mode (kernel 2 at the qkv sites): x [M, C] -> y = bf16(z) [M, O]
// alone, with the operands, shapes and launch plan of the tail mode
// (ops/ln_lora.py:qkv_fwd_plan). use_drop: hash stream 0 at threshold thr.
extern "C" int mtlora_ln_lora_qkv_fwd(
    const void* x, const void* gamma, const void* beta, const void* wt,
    const void* bias, const void* at, const void* bt, const void* seed,
    void* y, int M, int C, int O, int r, int bm, int splits, int per_sm,
    int blocks, int stages, int group, int smem, float scale, unsigned thr,
    int use_drop, float inv_keep, void* stream) {
  return run(x, gamma, beta, wt, bias, at, bt, seed, y, nullptr, nullptr, M,
             C, O, r, 0, bm, splits, per_sm, blocks, stages, group, smem,
             scale, thr, use_drop, inv_keep, stream);
}
