// Fused MTLoRA adapter MLP tail (backward) for Hopper: one pass over the
// hidden elements. With z, h = gelu(z) and gelu'(z) recomputed (never
// stored; the tanh form, lnk::kGelu), the cast points of _bwd_kernel:
//   u   = sum_r mid1[t,r,m] B1[t,r,h]       fp32, z = p1 + s_t u
//   dh  = sum_j g[t,j,m] A2T[t,j,h]         fp32
//   dz  = bf16(dh gelu'(z))
//   dp1 = bf16(sum_t dz)                    fp32 sum in task order
//   dmid1[t,r,m] = bf16(s_t sum_h B1[t,r,h] dz[h])
//   dB1[t,r,h]   = s_t sum_m mid1[t,r,m] dz[m,h]      fp32
//   dA2T[t,j,h]  = sum_m g[t,j,m] bf16(h)[m,h]        fp32
//
// Replaces mtlora_tpu/ops/pallas_adapter_mlp.py: _bwd_kernel, launched by
// _run_bwd from _bwd_rule, the custom VJP of fused_adapter_mid; with the
// activation form a template parameter, also the backward probe of
// tools/adapter_variants.py (make_bwd :136 through make_bwd_fn :209, with
// erf_pair :173 or sig_pair :178), at T = 4.
//
// What bounds it: the fp32 work a hidden element and task (z's add, the
// GELU and its derivative from one tanhf, dz's product, dp1's sum) at
// T*M*H4 elements, and the MUFU under tanhf; the bytes (p1 in, dp1 out)
// are a third of that time. Every rank product is an mma.sync m16n8k16 on
// bf16 tensor cores, because the four tasks' ranks together, T*R = 16, are
// one mma depth: a row's 16 (task, rank) values of mid1 (or g) are one A
// fragment row, and task t's fragment zeros the other tasks' entries.
//   - u_t and dh_t: A = masked mid1 (g) rows [m][tr], B = B1 (A2T) of all
//     tasks, [h][tr] in shared memory; both come out in the C layout, so
//     z, the GELU pair and dz are formed element-wise in registers.
//   - dmid1_t = dz_t B1_t^T: dz_t's C fragments of two n8 tiles, packed to
//     bf16, are the A fragment (16 columns deep); B is the same [h][tr]
//     tile read by ldmatrix.trans (n = the 8 (task, rank) of two tasks,
//     masked to task t), so tasks 0-1 and 2-3 share an accumulator.
//   - dB1 and dA2T contract over rows: dz_t and bf16(h_t) are transposed
//     in registers (movmatrix) into B fragments, and task t's masked
//     mid1^T (g^T) is A, all tasks summing into one 16-row accumulator a
//     column tile.
//   - dp1 = sum_t bf16(dz_t), in task order: dz_t's A fragment times the
//     8 x 8 identity, into an fp32 accumulator.
// The columns of a pair of n8 tiles are permuted (logical column c of tile
// j is column 4 (c / 2) + 2 j + c % 2 of the pair), so that a lane's four
// p1 values of a row are adjacent: p1 is read and dp1 written as 8 bytes a
// lane and row, whole 32-byte sectors, straight from device memory into
// the C layout (the next pair's values loaded under the current pair's
// work), with no shared-memory tile and no block barrier for them.
//
// Layout of the work: a block of kWarps warps owns a chunk of columns (kWarps *
// 16 kPairs, a warp kPairs pairs of n8 tiles) and walks a stripe of row tiles
// of kRows rows in 16-row steps; mid1 and g of a tile are staged in shared
// memory as [tr][m] (the next tile's while the block sums this one's dmid1
// partials), so their A fragments come from ldmatrix. Occupancy
// is what the fp32 chain needs (tanhf's MUFU and FMA latencies): two blocks an
// SM at 128 registers a thread, so the dB1 and dA2T sums of a lane's pairs wait
// in shared memory between 16-row steps (16 fp32 a pair) rather than in
// registers. The warps' dmid1 partials meet in shared memory and are summed in
// warp order; with one chunk (H4 <= kWarps * 16 kPairs) dmid1 is written as
// bf16, otherwise as fp32 partials a chunk, summed in chunk order by
// dmid_sum_kernel. dB1 and dA2T are written as fp32 partials a stripe and
// summed in stripe order (lnk::sum_parts). No fp32 atomics: two launches are
// bit-identical. ops/adapter_mlp.py:bwd_plan is the launch plan; the kernel
// traps if the shared-memory bytes do not hold its layout.

#include "adapter_mlp.cuh"

namespace {

using namespace adk;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerSm = 2;          // blocks an SM (bwd_plan's BWD_PER_SM)
constexpr int kMaxH4 = 4096;
constexpr int kPairs = 3;          // column pairs a warp (BWD_PAIRS)
constexpr int kRows = 64;          // rows a tile (BWD_ROWS)
constexpr int kCols = kWarps * 16 * kPairs;   // columns a chunk

struct BwdParams {
  const bf16 *mid1, *p1, *b1, *a2, *g;  // [T,R,M] [M,H4] [T,R,H4]x2 [T,R,M]
  bf16 *dmid1, *dp1;                      // [T,R,M], [M,H4]
  float* part;        // [stripes][2][T*R][H4]: dB1, dA2T a stripe
  float* dmid_part;   // [chunks][T*R][M] where chunks > 1
  int M, H4, chunks, tps;   // tps: row tiles a stripe
  float s[kMaxT];
};

// Bytes of shared memory: B1 and A2T of the chunk's columns as [h][16]
// bf16, mid1 and g of a row tile as [16][kRows + 8] bf16, the warps' dmid1
// partials [kWarps][16][kRows] fp32, and each lane's dB1 and dA2T sums of
// its warp's pairs, [kWarps][kPairs][4][32] float4.
__host__ __device__ constexpr int bwd_smem_bytes() {
  return 2 * kWarps * 16 * kPairs * kTR * 2 + 2 * kTR * (kRows + 8) * 2 +
         kWarps * kTR * kRows * 4 + kWarps * kPairs * 4 * 32 * 16;
}

__device__ __forceinline__ uint32_t movtrans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// Task t's scale (a select, so that the parameters stay in their bank).
__device__ __forceinline__ float task_scale(const BwdParams& a, int t) {
  return t == 0 ? a.s[0] : t == 1 ? a.s[1] : t == 2 ? a.s[2] : a.s[3];
}

// mid1 and g of the row tile at m0, element-wise: rows tr < T R of [T, R,
// M] (the rest zero), columns m0 .. m0 + kRows (zero past M).
template <int T>
__device__ __forceinline__ void stage_rank_tile(bf16* rk, const bf16* mid1,
                                                const bf16* g, int M,
                                                int m0) {
  constexpr int per = kTR * (kRows / 8);
  for (int i = threadIdx.x; i < 2 * per; i += kThreads) {
    const int arr = i / per, rem = i - arr * per;
    const int tr = rem / (kRows / 8), c = rem - tr * (kRows / 8);
    const int m = m0 + 8 * c;
    const int n = tr < T * R ? max(0, min(8, M - m)) : 0;
    const bf16* src = (arr ? g : mid1) + (size_t)tr * M + m;
    bf16* dst = rk + (arr * kTR + tr) * (kRows + 8) + 8 * c;
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = e < n ? src[e] : __float2bfloat16(0.f);
  }
}

template <int T, Act A>
__global__ void __launch_bounds__(kThreads, kPerSm)
    adapter_mid_bwd_fused(BwdParams a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = a.M, H4 = a.H4;
  if (blockDim.x != kThreads || bwd_smem_bytes() > (int)dynamic_smem_bytes())
    __trap();
  bf16* wb = reinterpret_cast<bf16*>(smem);           // B1 [kCols][16]
  bf16* wa = wb + kCols * kTR;                         // A2T [kCols][16]
  bf16* rk = wa + kCols * kTR;                         // [2][16][kRows + 8]
  float* red = reinterpret_cast<float*>(rk + 2 * kTR * (kRows + 8));
  float4* wacc = reinterpret_cast<float4*>(red + kWarps * kTR * kRows);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * kCols, chunk = blockIdx.x;
  const int tiles = (M + kRows - 1) / kRows;
  const int t0 = blockIdx.y * a.tps, t1 = min(tiles, t0 + a.tps);

  stage_weight_tiles<T>(wb, wa, a.b1, a.a2, H4, c0, kCols);
  const bf16* p1 = a.p1;
  if (t0 < t1) stage_rank_tile<T>(rk, a.mid1, a.g, M, t0 * kRows);

  // the warp's columns: pairs h0 = wc0 + 16 pp, local wl0 + 16 pp
  const int wl0 = warp * 16 * kPairs, wc0 = c0 + wl0;
  // ldmatrix row of this lane in a pair's weight tile: matrix l / 8 = (j,
  // k half), row l % 8 = column 4 (i / 2) + 2 j + i % 2
  const int li = lane & 7, lj = (lane >> 4) & 1, lk = (lane >> 3) & 1;
  const int lrow = 4 * (li >> 1) + 2 * lj + (li & 1);
  // the task half of the lane's entries: in the u / dh A fragment (k =
  // 2 q.. and 8 + 2 q..: task q / 2, 2 + q / 2), and in the dB1 / dA2T A
  // fragment and the dmid1 B fragment (row or column g: task g / 4, 2 +
  // g / 4)
  const bool qu = q >> 1, gu = g8 >> 2;
  // B fragment of the 8 x 8 identity (bf16 1.0 where k = n): k = 2 q, 2 q +
  // 1 against n = g
  const uint32_t eye = (g8 == 2 * q ? 0x3f80u : 0u) |
                       (g8 == 2 * q + 1 ? 0x3f800000u : 0u);

  // the lane's dB1 / s and dA2T sums of pair pp, C fragments of [tr][h]
  // tiles j = 0, 1: float4 v of wacc + (warp kPairs + pp) 128 + 32 v + lane
  // (v: dB1 j 0, 1, dA2T j 0, 1), kept in shared memory between pairs
  float4* lacc = wacc + warp * kPairs * 128 + lane;
  for (int v = 0; v < kPairs * 4; ++v)
    lacc[32 * v] = make_float4(0.f, 0.f, 0.f, 0.f);

  uint2 pn[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};
  if (t0 < t1 && wc0 < H4)
    load_p(pn, p1, M, H4, t0 * kRows, wc0, g8, q);

  for (int tile = t0; tile < t1; ++tile) {
    const int m0 = tile * kRows;
    __syncthreads();   // this tile's rank rows; the last tile's red read
    const bf16* smid = rk;
    const bf16* sg = rk + kTR * (kRows + 8);
#pragma unroll 1   // one 16-row step at a time (registers)
    for (int sub = 0; sub < kRows / 16; ++sub) {
      const int r0 = m0 + 16 * sub;
      // A fragments: mid1 / g rows [m][tr] (ldmatrix.trans of [tr][m])
      // and their transposes [tr][m]
      uint32_t am[4], ag[4], amt[4], agt[4];
      {
        const int mi = lane >> 3;
        const int ua = ((mi >> 1) * 8 + li) * (kRows + 8) + 16 * sub +
                       (mi & 1) * 8;
        const int ut = ((mi & 1) * 8 + li) * (kRows + 8) + 16 * sub +
                       (mi >> 1) * 8;
        ldsm_x4_t(am, smid + ua);
        ldsm_x4_t(ag, sg + ua);
        ldsm_x4(amt, smid + ut);
        ldsm_x4(agt, sg + ut);
      }
      float dm[2][4];   // dmid1 / s: [m][8 tr] of tasks 0-1 and 2-3
#pragma unroll
      for (int G = 0; G < 2; ++G)
#pragma unroll
        for (int e = 0; e < 4; ++e) dm[G][e] = 0.f;
#pragma unroll
      for (int pp = 0; pp < kPairs; ++pp) {
        const int h0 = wc0 + 16 * pp;
        const uint2 pc[2] = {pn[0], pn[1]};
        // the next pair's p1 (this sub's, the next sub's, the next tile's)
        {
          const int nh = pp + 1 < kPairs ? h0 + 16 : wc0;
          const int nr = pp + 1 < kPairs ? r0
                         : sub + 1 < kRows / 16 ? r0 + 16
                         : tile + 1 < t1    ? m0 + kRows
                                            : -1;
          if (nr >= 0 && nh < H4) load_p(pn, p1, M, H4, nr, nh, g8, q);
        }
        if (h0 >= H4) continue;   // the chunk's columns past H4
        uint32_t bb[4], ba[4], bt[4];
        {
          const int o = wt_off(wl0 + 16 * pp + lrow, 8 * lk);
          ldsm_x4(bb, wb + o);
          ldsm_x4(ba, wa + o);
          ldsm_x4_t(bt, wb + o);
        }
        float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float accb[2][4], acca[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 b = lacc[128 * pp + 32 * j];
          const float4 c = lacc[128 * pp + 32 * (2 + j)];
          accb[j][0] = b.x, accb[j][1] = b.y, accb[j][2] = b.z,
          accb[j][3] = b.w;
          acca[j][0] = c.x, acca[j][1] = c.y, acca[j][2] = c.z,
          acca[j][3] = c.w;
        }
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int hi = t >> 1, sel = t & 1;
          const uint32_t z0 = 0u;
          const uint32_t au[4] = {hi ? z0 : of_half(am[0], qu, sel),
                                  hi ? z0 : of_half(am[1], qu, sel),
                                  hi ? of_half(am[2], qu, sel) : z0,
                                  hi ? of_half(am[3], qu, sel) : z0};
          const uint32_t ad[4] = {hi ? z0 : of_half(ag[0], qu, sel),
                                  hi ? z0 : of_half(ag[1], qu, sel),
                                  hi ? of_half(ag[2], qu, sel) : z0,
                                  hi ? of_half(ag[3], qu, sel) : z0};
          uint32_t dzp[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float u[4] = {0.f, 0.f, 0.f, 0.f}, dh[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16_16816(u, au, bb[2 * j], bb[2 * j + 1]);
            mma_bf16_16816(dh, ad, ba[2 * j], ba[2 * j + 1]);
            float gl[4], dz[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t pw = j ? pc[e >> 1].y : pc[e >> 1].x;
              const float pv = (e & 1) ? hi_f(pw) : lo_f(pw);
              float dg;
              act_pair<A>(fmaf(task_scale(a, t), u[e], pv), &gl[e], &dg);
              dz[e] = dh[e] * dg;
            }
            dzp[j][0] = pack_bf16(dz[0], dz[1]);
            dzp[j][1] = pack_bf16(dz[2], dz[3]);
            const uint32_t hp0 = pack_bf16(gl[0], gl[1]);
            const uint32_t hp1 = pack_bf16(gl[2], gl[3]);
            // dB1 += mid1_t^T dz_t, dA2T += g_t^T bf16(h_t) over the 16 rows
            const uint32_t atm[4] = {hi ? z0 : of_half(amt[0], gu, sel),
                                     hi ? of_half(amt[1], gu, sel) : z0,
                                     hi ? z0 : of_half(amt[2], gu, sel),
                                     hi ? of_half(amt[3], gu, sel) : z0};
            const uint32_t atg[4] = {hi ? z0 : of_half(agt[0], gu, sel),
                                     hi ? of_half(agt[1], gu, sel) : z0,
                                     hi ? z0 : of_half(agt[2], gu, sel),
                                     hi ? of_half(agt[3], gu, sel) : z0};
            mma_bf16_16816(accb[j], atm, movtrans(dzp[j][0]),
                           movtrans(dzp[j][1]));
            mma_bf16_16816(acca[j], atg, movtrans(hp0), movtrans(hp1));
          }
          // dmid1 += dz_t B1_t^T over the pair's 16 columns
          const uint32_t adz[4] = {dzp[0][0], dzp[0][1], dzp[1][0],
                                   dzp[1][1]};
          mma_bf16_16816(dm[hi], adz, of_half(bt[hi], gu, sel),
                         of_half(bt[2 + hi], gu, sel));
          // dp1 += bf16(dz_t), in task order: dz_t's 16 columns times the
          // identity, one n8 tile at a time
          mma_bf16_16816(dp[0], adz, eye, 0u);
          mma_bf16_16816(dp[1], adz, 0u, eye);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          lacc[128 * pp + 32 * j] =
              make_float4(accb[j][0], accb[j][1], accb[j][2], accb[j][3]);
          lacc[128 * pp + 32 * (2 + j)] =
              make_float4(acca[j][0], acca[j][1], acca[j][2], acca[j][3]);
        }
        // dp1: rows g and g + 8, the lane's 4 adjacent columns
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = r0 + g8 + 8 * i;
          if (m < M)
            *reinterpret_cast<uint2*>(a.dp1 + (size_t)m * H4 + h0 + 4 * q) =
                make_uint2(pack_bf16(dp[0][2 * i], dp[0][2 * i + 1]),
                           pack_bf16(dp[1][2 * i], dp[1][2 * i + 1]));
        }
      }
      // the warp's dmid1 partial of these 16 rows: column 2 q + e of
      // group G is tr = 8 G + 2 q + e
      float* rw = red + warp * kTR * kRows + 16 * sub + g8;
#pragma unroll
      for (int G = 0; G < 2; ++G)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rw[(8 * G + 2 * q + (e & 1)) * kRows + 8 * (e >> 1)] = dm[G][e];
    }
    __syncthreads();   // red complete; rk free
    if (tile + 1 < t1) stage_rank_tile<T>(rk, a.mid1, a.g, M, m0 + kRows);
    for (int i = threadIdx.x; i < T * R * kRows; i += kThreads) {
      const int tr = i / kRows, ml = i - tr * kRows, m = m0 + ml;
      if (m >= M) continue;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[(w * kTR + tr) * kRows + ml];
      if (a.chunks == 1)
        a.dmid1[(size_t)tr * M + m] =
            __float2bfloat16(task_scale(a, tr / R) * v);
      else
        a.dmid_part[((size_t)chunk * T * R + tr) * M + m] = v;
    }
  }

  // the stripe's partials: row tr of the [tr][h] tiles, columns 4 q.. of
  // each pair (logical 2 q.. of both tiles)
  float* out = a.part + (size_t)blockIdx.y * 2 * T * R * H4;
#pragma unroll
  for (int pp = 0; pp < kPairs; ++pp) {
    const int h0 = wc0 + 16 * pp;
    if (h0 >= H4) continue;
    float accb[2][4], acca[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float4 b = lacc[128 * pp + 32 * j];
      const float4 c = lacc[128 * pp + 32 * (2 + j)];
      accb[j][0] = b.x, accb[j][1] = b.y, accb[j][2] = b.z, accb[j][3] = b.w;
      acca[j][0] = c.x, acca[j][1] = c.y, acca[j][2] = c.z, acca[j][3] = c.w;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tr = g8 + 8 * i;
      if (tr >= T * R) continue;
      const float s = task_scale(a, tr / R);
      const size_t o = (size_t)tr * H4 + h0 + 4 * q;
      *reinterpret_cast<float4*>(out + o) =
          make_float4(s * accb[0][2 * i], s * accb[0][2 * i + 1],
                      s * accb[1][2 * i], s * accb[1][2 * i + 1]);
      *reinterpret_cast<float4*>(out + (size_t)T * R * H4 + o) =
          make_float4(acca[0][2 * i], acca[0][2 * i + 1],
                      acca[1][2 * i], acca[1][2 * i + 1]);
    }
  }
}

// dmid1[tr][m] = bf16(s_t sum_c part[c][tr][m]), the chunks in order.
__global__ void dmid_sum_kernel(const float* __restrict__ part, int chunks,
                                int TR, int M, const BwdParams a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t E = (size_t)TR * M;
  if (i >= E) return;
  a.dmid1[i] = __float2bfloat16(task_scale(a, (int)(i / M / R)) *
                                chunk_sum(part, chunks, E, i));
}

template <int T, Act A>
cudaError_t run(const BwdParams& a, int stripes, int smem, float* dw,
                cudaStream_t st) {
  auto kern = adapter_mid_bwd_fused<T, A>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.chunks, stripes), kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.chunks > 1) {
    const size_t E = (size_t)T * R * a.M;
    dmid_sum_kernel<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(
        a.dmid_part, a.chunks, T * R, a.M, a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return lnk::sum_parts(a.part, stripes, 2 * (size_t)T * R * a.H4, dw, st);
}

// The instance of T tasks (the probes' forms: T = 4 only).
template <Act A>
cudaError_t run_t(int T, const BwdParams& a, int stripes, int smem,
                  float* dw, cudaStream_t st) {
  if constexpr (A != kGelu) {
    return run<kMaxT, A>(a, stripes, smem, dw, st);
  } else {
    return T == 1   ? run<1, A>(a, stripes, smem, dw, st)
           : T == 2 ? run<2, A>(a, stripes, smem, dw, st)
           : T == 3 ? run<3, A>(a, stripes, smem, dw, st)
                    : run<4, A>(a, stripes, smem, dw, st);
  }
}

// The activations' ids, which adapter_mlp.py's BWD_PROBES and KERNEL5B_ACT
// name: kBwdTanh is kernel 5b and runs at any T <= 4; the probes at T = 4.
enum BwdId {
  kBwdErf = 0,    // the probe's erf_pair
  kBwdTanh = 1,   // kernel 5b
  kBwdSig = 2,    // sig_pair
};
static_assert(kGelu == Act::Tanh, "kernel 5b is the tanh form");

}  // namespace

// mid1T [T, 4, M], p1 [M, H4], b1, a2T [T, 4, H4], g [T, 4, M] (bf16) ->
// dmid1T [T, 4, M], dp1 [M, H4] (bf16) and dw [2][T][4][H4] (fp32: dB1,
// dA2T); part: fp32 scratch, [stripes][2][T][4][H4] and, where chunks >
// 1, [chunks][T][4][M] after it; act: a BwdId. The plan's numbers
// (ops/adapter_mlp.py:bwd_plan): chunks of kWarps * 16 kPairs columns,
// stripes of tps row tiles of kRows, smem bytes.
extern "C" int mtlora_adapter_mid_bwd(int act, const void* mid1,
                                      const void* p1, const void* b1,
                                      const void* a2, const void* g,
                                      void* dmid1, void* dp1, void* part,
                                      void* dw, int T, int M, int H4,
                                      int chunks, int stripes, int tps,
                                      int smem, float s0, float s1, float s2,
                                      float s3, void* stream) {
  const int tiles = (M + kRows - 1) / kRows;
  if ((act != kBwdErf && act != kBwdTanh && act != kBwdSig) || T < 1 ||
      T > kMaxT || (act != kBwdTanh && T != kMaxT) || M < 1 || H4 < 64 ||
      H4 % 64 || H4 > kMaxH4 || chunks != (H4 + kCols - 1) / kCols ||
      stripes < 1 || tps < 1 || (long long)stripes * tps < tiles ||
      smem < bwd_smem_bytes() || (uintptr_t)p1 % 16 || (uintptr_t)part % 16)
    return (int)cudaErrorInvalidValue;
  BwdParams a = {};
  a.mid1 = static_cast<const bf16*>(mid1);
  a.p1 = static_cast<const bf16*>(p1);
  a.b1 = static_cast<const bf16*>(b1);
  a.a2 = static_cast<const bf16*>(a2);
  a.g = static_cast<const bf16*>(g);
  a.dmid1 = static_cast<bf16*>(dmid1);
  a.dp1 = static_cast<bf16*>(dp1);
  a.part = static_cast<float*>(part);
  a.dmid_part = a.part + (size_t)stripes * 2 * T * R * H4;
  a.M = M;
  a.H4 = H4;
  a.chunks = chunks;
  a.tps = tps;
  a.s[0] = s0;
  a.s[1] = s1;
  a.s[2] = s2;
  a.s[3] = s3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(dw);
  const cudaError_t e =
      act == kBwdErf   ? run_t<Act::Erf>(T, a, stripes, smem, out, st)
      : act == kBwdSig ? run_t<Act::Sig>(T, a, stripes, smem, out, st)
                       : run_t<kGelu>(T, a, stripes, smem, out, st);
  return (int)e;
}
