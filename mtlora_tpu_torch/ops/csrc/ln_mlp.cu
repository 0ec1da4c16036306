// Fused LayerNorm + whole MLP with shared LoRA on both layers (forward)
// for Hopper:
//   ln = LN(x)                                     fp32 statistics
//   h  = bf16(ln) W1^T + b1 + s1 bf16(bf16(drop1(ln)) A1^T) B1^T
//   g  = gelu(h)                                   tanh form, fp32
//   y  = bf16(bf16(g) W2^T + b2 + s2 bf16(bf16(drop2(g)) A2^T) B2^T)
//
// Replaces mtlora_tpu/ops/pallas_ln_mlp.py: _fwd_kernel, launched by
// _run_fwd through fused_ln_mlp (the MLP of the blocks with no task
// streams). The GELU is the TPU kernel's bf16 form, the tanh form
// (lnk::kGelu); the port's unfused MLP keeps F.gelu's exact erf, as the
// JAX package's jnp path does.
//
// What bounds it: per row 2 * 2 * C * 4C FLOP of frozen GEMMs (+ the
// rank-64 adapters) for 4C bytes of x and y: 4C FLOP a byte, far above
// the card's ridge, so the tensor cores bound it. The TPU kernel's win,
// kept here, is that the [M, 4C] hidden (308 MB in bf16 at batch 32)
// never reaches device memory. Design: a block of 4 warps owns 16 rows;
// the LN tile and m1 stay in its shared memory; the hidden is walked in
// groups of 4 chunks of 64 columns: warp w makes chunk w's h -> GELU ->
// bf16(g) in a shared tile and adds its share of m2 = gd A2[chunk] with
// the dropped copy gd as an A operand straight from its registers (two n8
// accumulator tiles are one k16 A fragment); then each warp adds the
// group's g W2[:, group] to the
// C/4 columns of y it owns, held in registers (YT tiles of 8). The warps'
// m2 shares are summed in a fixed order at the end. Weights are read in
// their nn.Linear layouts straight from device memory through L1/L2. No
// TMA, wgmma or pipelining yet.

#include "ln_common.cuh"

namespace {

using namespace lnk;

struct MlpArgs {
  Rows R;
  const bf16 *gamma, *beta, *w1, *bias1, *a1, *bb1, *w2, *bias2, *a2, *bb2;
  bf16* y;
  int H4, r;
  float s1, s2;
  DropSpec d1, d2;
};

constexpr int kG = 4 * 64 + 8;     // row stride of the 4-chunk hidden tiles

// Shared memory of a block: LN tile [16][C + 8], m tile [16][72], the
// bf16(g) tile of one group of 4 hidden chunks [16][264] (bf16), the
// warps' m2 partials [4][1024] in fragment order, mu and inv [16] (fp32).
inline size_t block_bytes(int C) {
  return sizeof(bf16) * kRows * ((size_t)(C + 8) + kT + kG) +
         sizeof(float) * (4 * 1024 + 2 * kRows);
}

// YT: n-tiles of 8 of the y columns a warp owns (C / 4 <= 8 YT).
template <int YT>
__global__ void __launch_bounds__(128) ln_mlp_fwd_kernel(MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.R.K, M = a.R.M, H4 = a.H4, r = a.r, ld = C + 8;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kRows;
  const int cw = C / 4, c_lo = warp * cw;
  bf16* tile = reinterpret_cast<bf16*>(smem);
  bf16* ms = tile + kRows * ld;           // m1, later m2
  bf16* gc = ms + kRows * kT;             // bf16(g) of the group
  float* m2p = reinterpret_cast<float*>(gc + kRows * kG);
  float* mu = m2p + 4 * 1024;
  float* inv = mu + kRows;
  float* m2mine = m2p + warp * 1024 + lane * 4;

  rows_stats(a.R, m0, mu, inv, warp, warps);
  __syncthreads();
  const Drop d1 = make_drop(a.d1), d2 = make_drop(a.d2);
  rows_ln_tile(tile, ld, a.R, a.gamma, a.beta, m0, mu, inv, d1, warp, warps);
  __syncthreads();
  {
    float acc[2][4];
    zero<2>(acc);
    mma_tile<2>(acc, tile, ld, a.a1, C, C, 16 * warp, r);
    store_tile<2>(ms, kT, acc, 16 * warp);
  }
  __syncthreads();
  if (d1.on) {
    rows_ln_tile(tile, ld, a.R, a.gamma, a.beta, m0, mu, inv, no_drop(),
                 warp, warps);
    __syncthreads();
  }
  {
    float z[8][4];
    zero<8>(z);
    store_frag(m2mine, z);
  }

  // the hidden in groups of 4 chunks of 64: warp w makes chunk w's g and
  // its m2 share, then every warp adds the group to its y columns
  float y[YT][4];
  zero<YT>(y);
  for (int hg = 0; hg < H4; hg += 4 * 64) {
    const int h0 = hg + 64 * warp;
    if (h0 < H4) {
      float h[8][4], u[8][4];
      zero<8>(h);
      zero<8>(u);
      mma_tile<8>(h, tile, ld, a.w1, C, C, h0, H4);
      mma_tile<8>(u, ms, kT, a.bb1, r, r, h0, H4);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = h0 + nt * 8 + 2 * t + (e & 1);
          const float hv =
              (h[nt][e] + __bfloat162float(a.bias1[col])) + a.s1 * u[nt][e];
          const float gl = act_fwd<kGelu>(hv);
          h[nt][e] = gl;
          u[nt][e] = d2.apply(gl, m0 + g + 8 * (e >> 1), H4, col);
        }
      store_tile<8>(gc, kG, h, 64 * warp);
      // m2 share: bf16(drop2(g)) straight from the registers
      load_frag(h, m2mine);
      mma_frag<8>(h, u, a.a2 + h0, H4, 0, r);
      store_frag(m2mine, h);
    }
    __syncthreads();
    mma_tile<YT>(y, gc, kG, a.w2 + hg, H4, min(4 * 64, H4 - hg), c_lo,
                 c_lo + cw);
    __syncthreads();
  }

  // ---- m2 = bf16(sum of the warps' shares), in order; y epilogue --------
  sum_frags(m2p, warps, ms, nullptr, 0, 0);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < YT; j += 8) {
    float u2[8][4];
    zero<8>(u2);
    mma_tile<8>(u2, ms, kT, a.bb2, r, r, c_lo + 8 * j, c_lo + cw);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (8 * (j + nt) >= cw) continue;
      const int c = c_lo + 8 * (j + nt) + 2 * t;
      const float2 b = bf2(a.bias2 + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + g + 8 * half;
        if (m < M)
          st_bf2(a.y + (size_t)m * C + c,
                 (y[j + nt][2 * half] + b.x) + a.s2 * u2[nt][2 * half],
                 (y[j + nt][2 * half + 1] + b.y) +
                     a.s2 * u2[nt][2 * half + 1]);
      }
    }
  }
}

}  // namespace

// x [M, C] -> y [M, C]. Weights in nn.Linear layouts: w1 [4C, C],
// a1 [r, C], bb1 [4C, r], w2 [C, 4C], a2 [r, 4C], bb2 [C, r]; bf16 biases.
extern "C" int mtlora_ln_mlp_fwd(const void* x, const void* gamma,
                                 const void* beta, const void* w1,
                                 const void* bias1, const void* a1,
                                 const void* bb1, const void* w2,
                                 const void* bias2, const void* a2,
                                 const void* bb2, const void* seed, void* y,
                                 int M, int C, int H4, int r, float s1,
                                 float s2, unsigned thr, int use_drop,
                                 float inv_keep, void* stream) {
  if (M < 1 || C % 32 || C > 768 || H4 % 64 || r != 64)
    return (int)cudaErrorInvalidValue;
  MlpArgs a;
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
  a.r = r;
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
  const size_t smem = block_bytes(C);
  const int yt = C / 32;   // n-tiles of 8 per warp: C / 4 columns
  void (*kern)(MlpArgs) = yt <= 8    ? ln_mlp_fwd_kernel<8>
                          : yt <= 16 ? ln_mlp_fwd_kernel<16>
                                     : ln_mlp_fwd_kernel<24>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(M + kRows - 1) / kRows, 128, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
