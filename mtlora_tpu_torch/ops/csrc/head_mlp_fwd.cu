// The fused HRNet decode head (forward, kernel 7) for Hopper:
//   y = bf16( relu( bf16( bf16(x We + be) * mul ) + add ) Wp + bp )
// with x We and z Wp accumulated in fp32, hc = bf16(x We + be), the BN
// affine (mul, add: folded from the statistics outside, each rounded to
// bf16 first) in bf16, and y rounded to bf16. Its backward is
// head_mlp_bwd.cu (kernel 7b).
//
// Replaces mtlora_tpu/ops/pallas_head.py: _fwd_kernel (:96), launched by
// _run_fwd (:187, call :192) through fused_head_mlp (:164).
//
// What bounds it: a row takes 2 C O + 2 O n FLOP (C = 270, O = 1080,
// n <= 21) for 2 (C + n) bytes in and out, about 1,100 FLOP a byte, far
// above the card's ~295 ridge: the operations bound it, 0.2437 ms a pass
// of the four tasks' heads at batch 32 (x [100,352, 270]; chip_smoke.py
// prints the bound). The TPU kernel's win, kept, is that the [M, O]
// hidden (217 MB in bf16 at batch 32) never reaches device memory. The
// first port reached 0.056 of the bound: blocks of 4 warps on 64 rows,
// every hidden chunk's We^T copied by 32-bit loads between two block
// barriers, B fragments by scalar shared loads, z through shared memory,
// and all of We^T read again from L2 for every 64 rows. Design:
//   - persistent blocks, one an SM, of two consumer warpgroups and a
//     producer warpgroup walk tiles of 128 rows, 64 a warpgroup (the last
//     tile masks its rows past M). A warp holds its 16 rows of x as the A
//     fragments of all 17 k-steps of C padded to kKp = 272 (68 registers,
//     zeros past C), for the whole tile;
//   - a warpgroup's 64 rows of x are one contiguous span (rows of 2 C
//     bytes, 540 at C = 270, which no tensor map takes): the producer
//     copies it by one bulk copy into the warpgroup's buffer, the next
//     tile's as soon as the warpgroup has read this one's, under the
//     products. The span's last bytes past a multiple of 16 (a ragged
//     tile) it copies itself;
//   - the hidden in chunks of 64 columns. A ring stage holds a chunk's
//     We^T rows as kSlices = 4 slots of 64 x 64 and a tail slot of the
//     last 16 columns (from a copy padded to [O, 272] per call: 540-byte
//     rows take no tensor map either), Wp^T's 64 columns as a slot of n
//     padded to NP = 16, 32, 48 or 64 rows, and the chunk's eb, bf16(mul)
//     and bf16(add) (512 bytes, zeros past O, made with the padded copy).
//     The producer's one thread fills the stages by TMA (128-byte
//     swizzle, 32-byte for the tail; zeros outside the arrays), a full and
//     an empty mbarrier a stage: no block barrier, and the stages ahead
//     (3 of 4 up to NP = 32, 2 of 3 above) load while a chunk is
//     multiplied. The producer's warpgroup gives the consumers its
//     registers (setmaxnreg, 232 a consumer thread). Every staged We^T
//     byte serves 128 rows;
//   - h = x We^T for the warpgroup's 64 rows and the chunk's 64 columns
//     by wgmma (m64n64k16, A from registers, B the slots through their
//     swizzled descriptors, the compile-time kKs = 17 k-steps: the tail's
//     one among them), fp32 in 32 registers a thread, waited for before
//     the chunk's epilogue: the other warpgroup's products run under it;
//   - bias, BN affine and ReLU on bf16 pairs (hc rounded once from fp32,
//     then a bf16x2 multiply, add and max: each rounded once, as the plain
//     version's bf16 ops) leave bf16(z) packed as the A fragments of the
//     second product: mma.sync m16n8k16 adds it into the warp's [16, NP]
//     output in registers across the chunks, Wp^T's B fragments by
//     ldmatrix from its swizzled slot. z past O is 0 (zero vectors, zero
//     We^T rows), as are Wp^T's columns past O;
//   - y = bf16(out + bp), stores masked to the rows below M and the n
//     outputs.
// On an H100 (700 W) the pass reaches about half of its bound. 13% fewer
// stage bytes (the 16-column tail) gained 1-2%, the warpgroups taking
// turns to issue nothing, two chunks in flight a warpgroup lost 14% (ptxas
// serializes their products): the products themselves bind
// (tools/ln_mlp_bwd_variants.py, head-fwd-* variants).
// The launch plan (ops/head.py:fwd_plan) owns rows, ring depth, blocks,
// shared-memory bytes and scratch; the kernel traps if the bytes do not
// hold its layout.

#include "tma.cuh"

namespace {

using namespace lnk;

constexpr int kWarps = 8;                     // consumer warps: 2 warpgroups
constexpr int kThreads = 32 * (kWarps + 4);   // and the producer warpgroup
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kTileRows = 128;                // rows of a tile
constexpr int kWgRows = 64;                   // rows of a warpgroup
constexpr int kS = 64;                        // a slot's width, a chunk
constexpr int kSlot = kS * kS;                // elements of a We^T slot
constexpr int kKp = 272;                      // C padded
constexpr int kKs = kKp / 16;                 // k-steps: 17
constexpr int kSlices = kKp / kS;             // 64-wide We^T slots: 4
constexpr int kTail = kKp - kSlices * kS;     // the last slot's width: 16
// a stage's bytes before Wp^T's slot: We^T's 64-wide slots, the tail slot
constexpr int kWpOff = 2 * kSlices * kSlot + 2 * kTail * kS;
constexpr int kNMax = 64;                     // outputs n
constexpr int kVecBytes = 512;                // eb (fp32), bf16 mul, add
constexpr int kMaxStages = 4;
static_assert(kS == kSliceW, "tma.cuh: swz, mma_slot");
static_assert(kTail == 16 && kKs == 4 * kSlices + 1,
              "the tail slot is one k-step");
static_assert(kWpOff % 1024 == 0, "Wp^T's slot on the swizzle's period");

struct Args {
  const bf16* x;              // [M, C]
  const unsigned char* vec;   // [chunks][kVecBytes]
  const float* pb;            // [n]
  bf16* y;                    // [M, n]
  int M, C, O, n, stages;
};

// The weights' tensor maps: the padded We^T [O, kKp] in 64 x 64 boxes
// (w) and its last 16 columns in 16 x 64 boxes (t, 32-byte swizzle),
// Wp^T [n, O] in boxes of 64 columns and NP rows (p).
struct Params {
  Args a;
  CUtensorMap w, t, p;
};

// Bytes of a ring stage: the chunk's We^T slots, Wp^T's slot of np rows,
// its vectors; a multiple of 1024 (the swizzle's period).
__host__ __device__ constexpr int stage_bytes(int np) {
  return kWpOff + 2 * np * kS + 1024;
}

// The bytes TMA brings into a stage.
__host__ __device__ constexpr int stage_tx(int np) {
  return kWpOff + 2 * np * kS + kVecBytes;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The wgmma descriptor of a K-major bf16 tile in a 128-byte-swizzled slot
// (1024-byte aligned; p steps 32 bytes a k-step inside it): rows of 128
// bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// The same for the tail slot: rows of 32 bytes (one k-step), 32-byte
// swizzle, 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t sw32_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (16ull << 32) | (3ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's committed product groups are
// pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving the accumulators' uses across the
// asynchronous products.
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B for the warpgroup's 64 rows and 64 columns: A the warp's 16
// rows from registers (mma.sync's A layout), B [64 n][16 k] by
// descriptor; acc 0 overwrites d. d: mma.sync's C layout, n-tile nt in
// d[4 nt ..].
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], const uint32_t* a,
                                            uint64_t desc, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// Starts h = x We^T[chunk] for the warpgroup: the kKs k-steps over the
// stage's slots, one committed group (wg_wait, then pin, before h is
// read).
__device__ __forceinline__ void issue_chunk(float (&h)[32],
                                            const uint32_t (*af)[4],
                                            const unsigned char* st) {
  const uint64_t d0 = sw128_desc(st);
  wg_fence();
  pin(h);
#pragma unroll
  for (int k = 0; k < kKs - 1; ++k)
    wgmma_64x64(h, af[k],
                d0 + (((k / 4) * 2 * kSlot + (k % 4) * 32) >> 4), k > 0);
  wgmma_64x64(h, af[kKs - 1], sw32_desc(st + 2 * kSlices * kSlot), 1);
  wg_commit();
}

// A chunk's epilogue: z = relu(bf16(bf16(hc) * bf16(mul)) + bf16(add)) on
// bf16 pairs from h and the stage's vectors, packed as the A fragments of
// the second product (n-tiles 2k and 2k + 1 are its k-step k), then
// out += bf16(z) Wp^T[chunk] from the stage's Wp^T slot.
template <int NT>
__device__ __forceinline__ void chunk_out(float (*out)[4],
                                          const float (&h)[32],
                                          const unsigned char* st, int t) {
  const bf16* wp = reinterpret_cast<const bf16*>(st + kWpOff);
  const float* ebv = reinterpret_cast<const float*>(wp + 8 * NT * kS);
  const __nv_bfloat162* mulv =
      reinterpret_cast<const __nv_bfloat162*>(ebv + kS);
  const __nv_bfloat162* addv = mulv + kS / 2;
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
  uint32_t zf[4][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * t;
    const float2 e = *reinterpret_cast<const float2*>(ebv + col);
    const __nv_bfloat162 m2 = mulv[col / 2], a2 = addv[col / 2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const __nv_bfloat162 hc = __floats2bfloat162_rn(
          h[4 * nt + 2 * hh] + e.x, h[4 * nt + 2 * hh + 1] + e.y);
      const __nv_bfloat162 z = __hmax2(__hadd2(__hmul2(hc, m2), a2), zero2);
      zf[nt >> 1][2 * (nt & 1) + hh] = *reinterpret_cast<const uint32_t*>(&z);
    }
  }
  mma_slot<NT>(out, zf, wp, 0, 4);
}

// The consumers' side of the ring: take() waits for the next stage to be
// full; release() gives back the oldest taken, once the warp is done with
// it (an arrival of each of the kWarps consumer warps frees a stage).
struct Stages {
  const unsigned char* buf;
  uint64_t *full, *empty;
  int bytes, stages;
  int s = 0, ph = 0, r = 0;

  __device__ __forceinline__ const unsigned char* take() {
    mbar_wait(full + s, ph);
    const unsigned char* st = buf + s * bytes;
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
    return st;
  }

  __device__ __forceinline__ void release() {
    __syncwarp();
    if (lane_id() == 0) mbar_arrive(empty + r);
    if (++r == stages) r = 0;
  }
};

// The block's tiles: the k-th is blockIdx.x + k gridDim.x.
__device__ __forceinline__ int tile_of(int k) {
  return (int)blockIdx.x + k * (int)gridDim.x;
}

// The producer's one thread: the j-th tile's x into both warpgroups'
// buffers, each once its warpgroup has read the tile before.
__device__ __forceinline__ void load_x(const Args& a, unsigned char* xbuf,
                                       uint64_t* xfull, uint64_t* xempty,
                                       int j) {
  const unsigned span = 2u * kWgRows * a.C;
  for (int wg = 0; wg < 2; ++wg) {
    mbar_wait(xempty + wg, (j & 1) ^ 1);
    fence_proxy_async();
    const int r0 = tile_of(j) * kTileRows + kWgRows * wg;
    const int rows = max(0, min(kWgRows, a.M - r0));
    const unsigned bytes = 2u * rows * a.C, main = bytes & ~15u;
    unsigned char* dst = xbuf + wg * span;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(a.x) + 2 * (size_t)r0 * a.C;
    for (unsigned b = main; b < bytes; b += 2)
      *reinterpret_cast<unsigned short*>(dst + b) =
          *reinterpret_cast<const unsigned short*>(src + b);
    mbar_expect(xfull + wg, main);
    if (main) bulk_copy(dst, src, main, xfull + wg);
  }
}

// The producer's one thread: every tile's chunks into the ring in order,
// a stage once the 8 consumer warps are done with it; the next tile's x
// after this tile's chunk stages - 1, whose stage the consumers free
// when they are done with the tile before (they read this tile's x then).
template <int NP>
__device__ __forceinline__ void produce(const Params& p, unsigned char* ring,
                                        unsigned char* xbuf, uint64_t* full,
                                        uint64_t* empty, uint64_t* xfull,
                                        uint64_t* xempty, int ntiles) {
  const Args& a = p.a;
  const int nch = (a.O + kS - 1) / kS, sb = stage_bytes(NP);
  const int next_x = min(a.stages, nch) - 1;
  int s = 0, ph = 0;
  load_x(a, xbuf, xfull, xempty, 0);
  for (int k = 0; k < ntiles; ++k)
    for (int c = 0; c < nch; ++c) {
      mbar_wait(empty + s, ph ^ 1);
      fence_proxy_async();
      unsigned char* st = ring + s * sb;
      mbar_expect(full + s, stage_tx(NP));
      for (int cs = 0; cs < kSlices; ++cs)
        tma_box(st + 2 * cs * kSlot, &p.w, full + s, kS * cs, kS * c);
      tma_box(st + 2 * kSlices * kSlot, &p.t, full + s, kS * kSlices,
              kS * c);
      tma_box(st + kWpOff, &p.p, full + s, kS * c, 0);
      bulk_copy(st + kWpOff + 2 * NP * kS,
                a.vec + (size_t)c * kVecBytes, kVecBytes, full + s);
      if (++s == a.stages) {
        s = 0;
        ph ^= 1;
      }
      if (c == next_x && k + 1 < ntiles)
        load_x(a, xbuf, xfull, xempty, k + 1);
    }
}

// NT = NP / 8 output n-tiles of a warp (even: mma_slot's pairs).
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    head_fwd_tiles(const __grid_constant__ Params p) {
  constexpr int NP = 8 * NT;
  static_assert(NT % 2 == 0 && NP <= kNMax, "n padded to 16, 32, 48, 64");
  extern __shared__ __align__(1024) unsigned char smem[];
  const Args& a = p.a;
  const int M = a.M, C = a.C, n = a.n, sb = stage_bytes(NP);
  // Dynamic shared memory, from its first 1024-byte boundary: the ring's
  // stages; the warpgroups' x buffers [2][64][C] (bf16); the ring's full
  // and empty mbarriers, then the x buffers' (2 each).
  unsigned char* ring_buf =
      smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  unsigned char* xbuf = ring_buf + a.stages * sb;
  uint64_t* full = reinterpret_cast<uint64_t*>(xbuf + 4 * kWgRows * C);
  uint64_t* empty = full + a.stages;
  uint64_t* xfull = empty + a.stages;
  uint64_t* xempty = xfull + 2;
  // the plan's bytes (ops/head.py:fwd_plan) must hold this layout
  if (reinterpret_cast<unsigned char*>(xempty + 2) - smem >
          (long)dynamic_smem_bytes() ||
      a.stages < 2 || a.stages > kMaxStages || n > NP)
    __trap();
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init_n(full + s, 1);
      mbar_init_n(empty + s, kWarps);
    }
    for (int wg = 0; wg < 2; ++wg) {
      mbar_init_n(xfull + wg, 1);
      mbar_init_n(xempty + wg, kWarps / 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the block's one barrier: the mbarriers are set
  const int tiles = (M + kTileRows - 1) / kTileRows;
  const int ntiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x;
  const int warp = threadIdx.x >> 5, lane = lane_id();
  if (warp >= kWarps) {   // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (warp == kWarps && lane == 0)
      produce<NP>(p, ring_buf, xbuf, full, empty, xfull, xempty, ntiles);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));

  const int g = lane >> 2, t = lane & 3, wg = warp >> 2, wq = warp & 3;
  const int nch = (a.O + kS - 1) / kS;
  const bf16* xs = reinterpret_cast<const bf16*>(xbuf) + wg * kWgRows * C;
  const int ra = 16 * wq + g, rb = ra + 8;   // the lane's rows of the 64
  Stages ring{ring_buf, full, empty, sb, a.stages};
#pragma unroll 1
  for (int k = 0; k < ntiles; ++k) {
    const int r0 = tile_of(k) * kTileRows + kWgRows * wg;
    const int rows = M - r0;
    // x's A fragments of the warp's 16 rows, zero past M and past C
    uint32_t af[kKs][4];
    mbar_wait(xfull + wg, k & 1);
#pragma unroll
    for (int kk = 0; kk < kKs; ++kk) {
      const int c0 = 16 * kk + 2 * t, c1 = c0 + 8;
      af[kk][0] = ra < rows && c0 < C ? ld32(xs + ra * C + c0) : 0u;
      af[kk][1] = rb < rows && c0 < C ? ld32(xs + rb * C + c0) : 0u;
      af[kk][2] = ra < rows && c1 < C ? ld32(xs + ra * C + c1) : 0u;
      af[kk][3] = rb < rows && c1 < C ? ld32(xs + rb * C + c1) : 0u;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(xempty + wg);

    // the chunks: each chunk's products, waited for, then its epilogue;
    // the other warpgroup's products run under it
    float out[NT][4];
    zero<NT>(out);
    float ha[32];
#pragma unroll 1
    for (int c = 0; c < nch; ++c) {
      const unsigned char* sa = ring.take();
      issue_chunk(ha, af, sa);
      wg_wait<0>();
      pin(ha);
      chunk_out<NT>(out, ha, sa, t);
      ring.release();
    }

    // y = bf16(out + bp), the rows below M and the n outputs
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e < 2 ? ra : rb), col = 8 * nt + 2 * t + (e & 1);
        if (r < rows && col < n)
          a.y[(size_t)(r0 + r) * n + col] =
              __float2bfloat16(out[nt][e] + a.pb[col]);
      }
  }
}

// We^T [O, C] -> wpad [O, kKp] (zeros past C); the chunks' vectors
// [chunks][kVecBytes]: eb (fp32), bf16(mul), bf16(add), 64 each, zeros
// past O.
__global__ void head_fwd_pad(const bf16* __restrict__ ek_t,
                             const float* __restrict__ eb,
                             const float* __restrict__ mul,
                             const float* __restrict__ add, int O, int C,
                             bf16* __restrict__ wpad,
                             unsigned char* __restrict__ vec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int nw = O * kKp, nch = (O + kS - 1) / kS;
  if (i < nw) {
    const int r = i / kKp, c = i - r * kKp;
    wpad[i] = c < C ? ek_t[(size_t)r * C + c] : __float2bfloat16(0.f);
    return;
  }
  const int j = i - nw;   // the hidden unit
  if (j >= nch * kS) return;
  unsigned char* v = vec + (size_t)(j / kS) * kVecBytes;
  const int jj = j % kS;
  const bool in = j < O;
  reinterpret_cast<float*>(v)[jj] = in ? eb[j] : 0.f;
  reinterpret_cast<bf16*>(v + 4 * kS)[jj] =
      __float2bfloat16(in ? mul[j] : 0.f);
  reinterpret_cast<bf16*>(v + 6 * kS)[jj] =
      __float2bfloat16(in ? add[j] : 0.f);
}

template <int NT>
cudaError_t launch(const Params& p, int blocks, int smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      head_fwd_tiles<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  head_fwd_tiles<NT><<<blocks, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// x [M, C], ek_t (We^T) [O, C], pk_t (Wp^T) [n, O] bf16; eb, mul, add
// [O], pb [n] fp32 -> y [M, n] bf16. stages, blocks and smem are the
// caller's launch plan (ops/head.py:fwd_plan); scratch wpad [O, 272]
// (bf16) and vec [ceil(O / 64) * 512] bytes. Even C <= 272, O % 8 == 0,
// 1 <= n <= 64.
extern "C" int mtlora_head_mlp_fwd(const void* x, const void* ek_t,
                                   const void* eb, const void* mul,
                                   const void* add, const void* pk_t,
                                   const void* pb, void* y, void* wpad,
                                   void* vec, int M, int cin, int hidden,
                                   int n_out, int stages, int blocks,
                                   int smem, void* stream) {
  const int tiles = (M + kTileRows - 1) / kTileRows;
  if (M < 1 || cin < 2 || (cin & 1) || cin > kKp || hidden < 8 ||
      hidden % 8 || n_out < 1 || n_out > kNMax || stages < 2 ||
      stages > kMaxStages || blocks < 1 || blocks > tiles)
    return (int)cudaErrorInvalidValue;
  // bulk copies of x's spans and the vectors, TMA boxes of the weights
  if (misaligned(x) || misaligned(pk_t) || misaligned(wpad) ||
      misaligned(vec))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = (hidden + kS - 1) / kS;
  const int total = hidden * kKp + nch * kS;
  head_fwd_pad<<<(total + 255) / 256, 256, 0, st>>>(
      static_cast<const bf16*>(ek_t), static_cast<const float*>(eb),
      static_cast<const float*>(mul), static_cast<const float*>(add), hidden,
      cin, static_cast<bf16*>(wpad), static_cast<unsigned char*>(vec));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nt = (n_out + 15) / 16 * 2;   // n-tiles of 8, in pairs
  Params p;
  p.a.x = static_cast<const bf16*>(x);
  p.a.vec = static_cast<const unsigned char*>(vec);
  p.a.pb = static_cast<const float*>(pb);
  p.a.y = static_cast<bf16*>(y);
  p.a.M = M;
  p.a.C = cin;
  p.a.O = hidden;
  p.a.n = n_out;
  p.a.stages = stages;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  if (!box_map(&p.w, wpad, hidden, kKp) ||
      !box_map(&p.t, wpad, hidden, kKp, kS, kTail,
               CU_TENSOR_MAP_SWIZZLE_32B) ||
      !box_map(&p.p, pk_t, n_out, hidden, 8 * nt))
    return (int)cudaErrorInvalidValue;
  e = nt == 2   ? launch<2>(p, blocks, smem, st)
      : nt == 4 ? launch<4>(p, blocks, smem, st)
      : nt == 6 ? launch<6>(p, blocks, smem, st)
                : launch<8>(p, blocks, smem, st);
  return (int)e;
}
