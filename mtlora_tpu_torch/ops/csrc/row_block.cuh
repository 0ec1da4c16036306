// A row block's rows of x in shared memory and the LayerNorm backward of
// their dln in registers: the parts that the fused row kernels of kernel
// 2b (ln_lora_tail_bwd.cu, the stage-tail mode; ln_lora_qkv_bwd.cu, the
// qkv sites) share, with the barrier of a two-block cluster.
#pragma once

#include "slice_ring.cuh"

namespace lnk {

// The rows m0.. of x staged in shared memory (row stride ld), as a row
// source of rows_stats and rows_ln_tile.
struct TileRows {
  const bf16* t;
  int M, K, ld, m0;
  __device__ __forceinline__ float2 pair(int m, int k) const {
    return bf2(t + (m - m0) * ld + k);
  }
};

// Rows m0.. of x (BM of them, zero past M) into a [BM][ld] tile, by
// cp.async from the block's kThreads threads.
template <int BM, int kThreads>
__device__ __forceinline__ void x_in(bf16* tile, int ld, const Rows& R,
                                     int m0) {
  const int vc = R.K / 8;
  for (int v = threadIdx.x; v < BM * vc; v += kThreads) {
    const int i = v / vc, c = (v - i * vc) * 8;
    const bool in = m0 + i < R.M;
    cp_async16(tile + i * ld + c, in ? R.x + (size_t)(m0 + i) * R.K + c : R.x,
               in);
  }
}

// The LayerNorm backward of a block's BM rows from dln in registers (warp
// (mi, ni) of WN per row: rows 16 mi.., columns 64 cs + 8 NT ni + 8 nt),
// as ln_mlp_bwd.cu's: dxhat = dln gamma in place of dln; the warp's
// 16-row partials of dgamma and dbeta to gb ([2][C] at the warp's row
// tile); the rows' sums of dxhat and dxhat xhat over the WN warps of a
// row (red [2][WN][BM] in shared memory, in warp order); then dx = inv
// (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) to rows m0 + i < M of dx
// [M, C]. R: the block's rows of x in shared memory (TileRows); mu, inv:
// its row statistics.
template <int BM, int NCS, int NT, int WN, class Src>
__device__ __forceinline__ void ln_bwd_rows(float (*dln)[NT][4], const Src& R,
                                            const bf16* gamma, const float* mu,
                                            const float* inv, float* red,
                                            float* gb, bf16* dx, int m0,
                                            int mi, int ni, int ncs) {
  const int C = R.K, M = R.M;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int wr = kRows * mi, wc = 8 * NT * ni;
  float rs1[2] = {0.f, 0.f}, rs2[2] = {0.f, 0.f};
#pragma unroll
  for (int cs = 0; cs < NCS; ++cs) {
    if (cs >= ncs || kSliceW * cs + wc >= C) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = kSliceW * cs + wc + 8 * nt + 2 * t;
      const float2 gm = bf2(gamma + c);
      float cg[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wr + g + 8 * half, m = m0 + rl;
        float v0 = 0.f, v1 = 0.f;
        if (m < M) {
          const float e0 = dln[cs][nt][2 * half], e1 = dln[cs][nt][2 * half + 1];
          const float2 xv = R.pair(m, c);
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
      if (cs >= ncs || kSliceW * cs + wc >= C) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = kSliceW * cs + wc + 8 * nt + 2 * t;
        const float2 xv = R.pair(m, c);
        const float xh0 = (xv.x - mn) * iv, xh1 = (xv.y - mn) * iv;
        st_bf2(dx + (size_t)m * C + c,
               iv * (dln[cs][nt][2 * half] - mm1 - xh0 * mm2),
               iv * (dln[cs][nt][2 * half + 1] - mm1 - xh1 * mm2));
      }
    }
  }
}

// Every thread of both blocks of a cluster arrives, and waits for the
// other block: its writes before are visible to the other's reads after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace lnk
