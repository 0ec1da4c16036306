// Fused MTLoRA adapter MLP tail (forward), kernel 5, for Hopper:
//   per task t, row m:  u   = sum_r mid1[t,r,m] B1[t,r]             fp32
//                       z   = p1[m] + s_t u                         fp32
//                       h   = bf16(gelu(z))                          tanh form
//                       mid2[t,j,m] = bf16(sum_h h A2T[t,j,h])       fp32 sum
//
// Replaces mtlora_tpu/ops/pallas_adapter_mlp.py: _fwd_kernel, launched by
// _run_fwd through fused_adapter_mid (fc2's task projection in the four
// stage-tail blocks, where fc1's task output stays factored). The GELU is
// the TPU kernel's bf16 form, the tanh form with tanhf (lnk::kGelu).
//
// What bounds it: the fp32 work a hidden element and task (z's fused
// multiply-add, the GELU around one tanhf, bf16(h)'s pack) at T M H4
// elements, issued on the CUDA cores beside tanhf's two MUFU operations;
// p1, read once for all tasks, is a fifth of that time. The [T, M, H4]
// task hidden never reaches device memory. Every rank product is an
// mma.sync m16n8k16 on bf16 tensor cores, because the four tasks' ranks
// together, T R = 16, are one mma depth:
//   - u_t: A = the 16 rows' (task, rank) values of mid1, task t's entries
//     kept and the others zeroed; B = B1 of all tasks, an [h][tr] tile in
//     shared memory read by ldmatrix. u_t comes out in the C layout of
//     two n8 tiles, where z, the GELU and bf16(h) are formed element-wise.
//   - mid2_t += h_t A2T_t^T: bf16(h_t)'s C fragments of the two tiles,
//     packed, are the A fragment (16 columns deep); B is the [h][tr] tile
//     of A2T read by ldmatrix.trans, n = the 8 (task, rank) of two tasks,
//     masked to task t, so tasks 0-1 and 2-3 share an accumulator.
// p1 is read straight from device memory into the C layout (adapter_mlp.cuh
// permutes a pair's columns so that a lane reads 8 bytes of a row), the
// next pair's values loaded under the current pair's work.
//
// Layout of the work: the columns split into chunks of at most kMaxCols
// (ops/adapter_mlp.py:fwd_plan picks the width); a block of kWarps warps
// stages its chunk's B1 and A2T once, then each warp walks 16-row steps
// on its own, each step over every pair of the chunk: the warp's
// projection sums stay in C fragments across the chunk, and no block
// barrier follows the staging. Step s of a chunk goes to warp (s /
// stripes) % kWarps of block s % stripes, so that a short chunk spreads
// over the SMs before it fills their warps. A step's [16 tr][16 m] result
// leaves through the warp's rows of shared memory as 16-byte stores along
// m: bf16 mid2T where one chunk covers H4, else fp32 partials a chunk,
// summed in chunk order by mid2_sum_kernel. No fp32 atomics: two launches
// are bit-identical. The kernel traps if the shared-memory bytes do not
// hold its layout.

#include "adapter_mlp.cuh"

namespace {

using namespace adk;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerSm = 2;          // blocks an SM (fwd_plan's FWD_PER_SM)
constexpr int kMaxCols = 384;      // columns a chunk at most (FWD_MAX_COLS)
constexpr int kMaxH4 = 4096;       // Swin-B's widest hidden (FWD_MAX_H4)
constexpr int kStg = 16 + 4;       // row stride of a warp's result rows

struct FwdParams {
  const bf16 *mid1, *p1, *b1, *a2;   // [T,R,M], [M,H4], [T,R,H4] x2
  bf16* out;                          // mid2T [T,R,M]
  float* part;                        // [chunks][T*R][M] where chunks > 1
  int M, H4, cols, chunks, stripes;
  float s[kMaxT];
};

// Bytes of shared memory: B1 and A2T of a chunk as [h][16] bf16, and each
// warp's [16][kStg] fp32 result rows.
__host__ __device__ constexpr int fwd_smem_bytes() {
  return 2 * kMaxCols * kTR * 2 + kWarps * kTR * kStg * 4;
}

// A lane's A fragment of the 16 rows at m0: mid1 as [m][tr] (rows g, g + 8;
// tr 2 q.. and 8 + 2 q..), from [T, R, M] (zeros past T R and M).
template <int T>
__device__ __forceinline__ void load_mid(uint32_t* am,
                                         const bf16* __restrict__ mid1,
                                         int M, int m0, int g8, int q) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int tr = 2 * q + 8 * (i >> 1), m = m0 + g8 + 8 * (i & 1);
    uint32_t v = 0u;
    if (tr < T * R && m < M) {
      const unsigned short* p =
          reinterpret_cast<const unsigned short*>(mid1 + (size_t)tr * M + m);
      v = (uint32_t)__ldg(p) | ((uint32_t)__ldg(p + M) << 16);
    }
    am[i] = v;
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads, kPerSm)
    adapter_mid_fwd_fused(FwdParams a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockDim.x != kThreads || fwd_smem_bytes() > (int)dynamic_smem_bytes())
    __trap();
  const int M = a.M, H4 = a.H4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g8 = lane >> 2, q = lane & 3;
  bf16* wb = reinterpret_cast<bf16*>(smem);            // B1 [kMaxCols][16]
  bf16* wa = wb + kMaxCols * kTR;                       // A2T [kMaxCols][16]
  float* stg = reinterpret_cast<float*>(wa + kMaxCols * kTR) +
               warp * kTR * kStg;                       // [16][kStg]
  const int chunk = blockIdx.y, c0 = chunk * a.cols;
  const int np = min(a.cols, H4 - c0) / 16;             // the chunk's pairs
  stage_weight_tiles<T>(wb, wa, a.b1, a.a2, H4, c0, 16 * np);
  __syncthreads();

  const int steps = (M + 15) / 16, V = a.stripes * kWarps;
  int st = warp * a.stripes + blockIdx.x;
  if (st >= steps) return;
  // ldmatrix row of this lane in a pair's weight tile: matrix l / 8 = (j,
  // k half), row l % 8 = column 4 (i / 2) + 2 j + i % 2
  const int li = lane & 7, lj = (lane >> 4) & 1, lk = (lane >> 3) & 1;
  const int lrow = 4 * (li >> 1) + 2 * lj + (li & 1);
  // the task half of the lane's entries: in the u A fragment (k = 2 q..
  // and 8 + 2 q..: task q / 2, 2 + q / 2), and in the projection's B
  // fragment (column g: task g / 4, 2 + g / 4)
  const bool qu = q >> 1, gu = g8 >> 2;

  uint32_t am[4];
  uint2 pn[2];
  load_mid<T>(am, a.mid1, M, 16 * st, g8, q);
  load_p(pn, a.p1, M, H4, 16 * st, c0, g8, q);
  for (; st < steps; st += V) {
    const int m0 = 16 * st, nst = st + V;
    uint32_t au[T][4];   // task t's A fragment: the others' entries zero
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int hi = t >> 1, sel = t & 1;
      au[t][0] = hi ? 0u : of_half(am[0], qu, sel);
      au[t][1] = hi ? 0u : of_half(am[1], qu, sel);
      au[t][2] = hi ? of_half(am[2], qu, sel) : 0u;
      au[t][3] = hi ? of_half(am[3], qu, sel) : 0u;
    }
    if (nst < steps) load_mid<T>(am, a.mid1, M, 16 * nst, g8, q);
    float mo[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
    for (int pp = 0; pp < np; ++pp) {
      const uint2 pc[2] = {pn[0], pn[1]};
      // the next pair's p1 (this step's, else the next step's first)
      {
        const bool more = pp + 1 < np;
        const int nr = more ? m0 : nst < steps ? 16 * nst : -1;
        if (nr >= 0)
          load_p(pn, a.p1, M, H4, nr, c0 + (more ? 16 * (pp + 1) : 0), g8,
                 q);
      }
      uint32_t bb[4], bt[4];
      {
        const int o = wt_off(16 * pp + lrow, 8 * lk);
        ldsm_x4(bb, wb + o);
        ldsm_x4_t(bt, wa + o);
      }
      float pv[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t pw = j ? pc[e >> 1].y : pc[e >> 1].x;
          pv[j][e] = (e & 1) ? hi_f(pw) : lo_f(pw);
        }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int hi = t >> 1, sel = t & 1;
        uint32_t ah[4];   // bf16(h_t) of the pair: the projection's A
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float u[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16_16816(u, au[t], bb[2 * j], bb[2 * j + 1]);
          float h[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            h[e] = act_fwd<kGelu>(fmaf(a.s[t], u[e], pv[j][e]));
          ah[2 * j] = pack_bf16(h[0], h[1]);
          ah[2 * j + 1] = pack_bf16(h[2], h[3]);
        }
        mma_bf16_16816(mo[hi], ah, of_half(bt[hi], gu, sel),
                       of_half(bt[2 + hi], gu, sel));
      }
    }
    // the step's result as [tr][m] rows: column 2 q + e of group G is tr =
    // 8 G + 2 q + e
#pragma unroll
    for (int G = 0; G < 2; ++G)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        stg[(8 * G + 2 * q + (e & 1)) * kStg + g8 + 8 * (e >> 1)] = mo[G][e];
    __syncwarp();
    {
      // lane: row tr, 8 consecutive m
      const int tr = lane >> 1, ml = 8 * (lane & 1), m = m0 + ml;
      if (tr < T * R && m < M) {
        const float4* row = reinterpret_cast<const float4*>(stg + tr * kStg);
        const float4 v0 = row[ml / 4], v1 = row[ml / 4 + 1];
        const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
        const bool whole = M % 8 == 0;   // m + 8 <= M, 16-byte aligned
        if (a.chunks == 1) {
          bf16* o = a.out + (size_t)tr * M + m;
          if (whole) {
            *reinterpret_cast<uint4*>(o) =
                make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                           pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (m + e < M) o[e] = __float2bfloat16(v[e]);
          }
        } else {
          float* o = a.part + ((size_t)chunk * T * R + tr) * M + m;
          if (whole) {
            reinterpret_cast<float4*>(o)[0] = v0;
            reinterpret_cast<float4*>(o)[1] = v1;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (m + e < M) o[e] = v[e];
          }
        }
      }
    }
    __syncwarp();
  }
}

// mid2T[i] = bf16(sum_c part[c][i]), the chunks in order (E = T R M).
__global__ void mid2_sum_kernel(const float* __restrict__ part, int chunks,
                                size_t E, bf16* __restrict__ out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < E) out[i] = __float2bfloat16(chunk_sum(part, chunks, E, i));
}

template <int T>
cudaError_t run(const FwdParams& a, int smem, cudaStream_t st) {
  auto kern = adapter_mid_fwd_fused<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.stripes, a.chunks), kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.chunks == 1) return e;
  const size_t E = (size_t)T * R * a.M;
  mid2_sum_kernel<<<(unsigned)((E + 255) / 256), 256, 0, st>>>(
      a.part, a.chunks, E, a.out);
  return cudaGetLastError();
}

}  // namespace

// mid1T [T, 4, M], p1 [M, H4], b1, a2T [T, 4, H4] (bf16) -> mid2T [T, 4,
// M] (bf16); part: fp32 scratch [chunks][T][4][M] where chunks > 1. The
// plan's numbers (ops/adapter_mlp.py:fwd_plan): chunks of cols columns
// (a multiple of 16, at most kMaxCols), stripes blocks a chunk, smem
// bytes. p1, b1 and a2T start on 16-byte boundaries.
extern "C" int mtlora_adapter_mid_fwd_fused(const void* mid1, const void* p1,
                                            const void* b1, const void* a2,
                                            void* out, void* part, int T,
                                            int M, int H4, int cols,
                                            int chunks, int stripes, int smem,
                                            float s0, float s1, float s2,
                                            float s3, void* stream) {
  if (T < 1 || T > kMaxT || M < 1 || H4 < 64 || H4 % 64 || H4 > kMaxH4 ||
      cols < 16 || cols % 16 || cols > kMaxCols ||
      chunks != (H4 + cols - 1) / cols || stripes < 1 ||
      smem < fwd_smem_bytes() || (uintptr_t)p1 % 16 || (uintptr_t)b1 % 16 ||
      (uintptr_t)a2 % 16 || (chunks > 1 && (uintptr_t)part % 16))
    return (int)cudaErrorInvalidValue;
  FwdParams a = {};
  a.mid1 = static_cast<const bf16*>(mid1);
  a.p1 = static_cast<const bf16*>(p1);
  a.b1 = static_cast<const bf16*>(b1);
  a.a2 = static_cast<const bf16*>(a2);
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.M = M;
  a.H4 = H4;
  a.cols = cols;
  a.chunks = chunks;
  a.stripes = stripes;
  a.s[0] = s0;
  a.s[1] = s1;
  a.s[2] = s2;
  a.s[3] = s3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(T == 1   ? run<1>(a, smem, st)
               : T == 2 ? run<2>(a, smem, st)
               : T == 3 ? run<3>(a, smem, st)
                        : run<4>(a, smem, st));
}
