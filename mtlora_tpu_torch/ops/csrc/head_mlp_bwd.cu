// Fused HRNet decode head (backward) for Hopper.
//
// Replaces mtlora_tpu/ops/pallas_head.py: _bwd_kernel (:111), launched by
// _bwd_rule (:210, call :224), the custom VJP of fused_head_mlp. With the
// forward's hidden recomputed once, the cast points of _bwd_kernel:
//   hc   = bf16(x We + be)                zpre = bf16(bf16(hc*mul) + add)
//   z    = relu(zpre)                     dz   = bf16(gy) Wp^T      (fp32)
//   dzp  = dz where zpre > 0              dh   = dzp * mul          (fp32 mul)
//   dhc  = bf16(dh)
//   dx   = dhc We^T     dWe = x^T dhc     dWp = z^T bf16(gy)
//   dbe  = sum dh       dmul = sum dzp*hc dadd = sum dzp    dbp = sum gy
// with every product accumulated in fp32.
//
// What bounds it: three products of M x C x O (h, dx, dWe; dz and dWp are
// n / C of one), ~290 FLOP per byte of x and gy at C = 270, O = 1080: by
// operations, on the card's ridge. The TPU kernel runs its grid in order
// and carries dWe, dWp and the column sums in VMEM from step to step, so
// the hidden never leaves the chip. Blocks on the H100 run in parallel and
// nothing carries over between them, so the sums over rows take a second
// pass; recomputing the hidden there costs a fourth product and a second
// walk over x and the weights. Design:
//   - a row kernel: a block of 8 warps owns 64 rows; its x tile [64 x 272]
//     and bf16(gy) tile [64 x NP] are copied once by cp.async (the block's
//     rows are one contiguous span each) and stay in shared memory. It
//     walks the hidden in chunks of 64: h and dz (warp tile 16 x 32), the
//     ReLU mask and the BN-affine backward in registers, then dx += dhc
//     We^T (warp tile 16 x 136, 68 fp32 registers a thread). C is padded
//     to 272 at compile time, so every k loop unrolls;
//   - the chunk's weights (the rows of We^T, the columns of Wp^T, eb, mul
//     and add) stream through a ring of 4 stages (3 where n > 32) filled by
//     cp.async, stages - 1 chunks ahead; one stage (35 KB of We^T) serves
//     4.5 MFLOP of products between two barriers. h reads the We^T rows
//     with ldmatrix, dx reads the same rows with ldmatrix.trans: no
//     transposed copy. Rows of We^T are 540 bytes at C = 270, not 16-byte
//     aligned, so the launch first copies We^T into a padded bf16 [O, 272]
//     array (0.59 MB, once per call);
//   - unlike the TPU kernel, the port writes dhc and z to device memory
//     (bf16 [M, O] each, 0.43 GB together at batch 32, read once), and x
//     and bf16(gy) as padded rows: dWe^T = dhc^T x and dWp^T = bf16(gy)^T z
//     are then products over the rows of stored tensors (lnk::wgrad, fp32
//     partials per stripe of rows summed in a fixed order), and the hidden
//     is computed once;
//   - the column sums (dbe, dmul, dadd from the unrounded values, dbp)
//     are written per block as fp32 partials and summed in a fixed order
//     (lnk::sum_parts). Deterministic, no fp32 atomics.
// The launch plan (ring depth, shared-memory bytes, scratch, stripes) is
// ops/head.py:bwd_plan; the kernel traps if the bytes do not hold its
// layout.

#include "ln_common.cuh"

namespace {

using namespace lnk;

constexpr int kBM = 64;          // rows of a block
constexpr int kHC = 64;          // hidden columns of a chunk
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNMax = 64;        // outputs n
constexpr int kKp = 272;         // inputs C <= kKp, padded to kKp
constexpr int kLdW = kKp + 8;    // row stride of the x and We^T tiles
constexpr int kCT = kKp / 16;    // dx n-tiles of a warp: 17
constexpr int kLdT = kHC + 8;    // row stride of the 64-wide tiles

struct Args {
  const bf16 *x, *wpad, *pk_t, *gy;
  const float *eb, *mul, *add;
  bf16 *dx, *xpad, *gypad, *dhc, *z;
  float* cols;
  int M, C, O, n, NP, NG;
};

// Bytes of one ring stage: We^T rows [kHC][kLdW], Wp^T columns
// [NP][kLdT] (bf16), eb, mul, add [3][kHC] (fp32).
__host__ __device__ __forceinline__ int stage_bytes(int NP) {
  return 2 * (kHC * kLdW + NP * kLdT) + 4 * 3 * kHC;
}

// The ring of hidden chunks. Every thread calls next() at the same points:
// chunk q is resident when next() returns it, and chunk q + S - 1 starts
// streaming into the stage of chunk q - 1, free because every thread
// passed the barrier after its last products on it. One cp.async group per
// chunk, empty past the end.
template <int S>
struct Ring {
  unsigned char* buf;
  int bytes, q, total;

  // A warp copies whole rows of We^T (kKp / 8 16-byte pieces each); the
  // Wp^T columns and the vectors go 8 and 16 pieces a row.
  __device__ __forceinline__ void load(const Args& a, int i) {
    if (i < total) {
      const int j0 = i * kHC;
      bf16* ws = reinterpret_cast<bf16*>(buf + (i % S) * bytes);
      bf16* ps = ws + kHC * kLdW;
      float* vs = reinterpret_cast<float*>(ps + a.NP * kLdT);
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int r = warp; r < kHC; r += kWarps) {
        const bool in = j0 + r < a.O;
        const bf16* src = a.wpad + (size_t)(j0 + r) * kKp;
        for (int c = 8 * lane; c < kKp; c += 8 * 32)
          cp_async16(ws + r * kLdW + c, in ? src + c : a.wpad, in);
      }
      for (int v = threadIdx.x; v < 8 * a.NP; v += kThreads) {
        const int o = v >> 3, c = (v & 7) * 8;
        const bool in = o < a.n && j0 + c < a.O;
        cp_async16(ps + o * kLdT + c,
                   in ? a.pk_t + (size_t)o * a.O + j0 + c : a.pk_t, in);
      }
      if (threadIdx.x < 3 * kHC / 4) {
        const int k = threadIdx.x >> 4, c = (threadIdx.x & 15) * 4;
        const float* src = k == 0 ? a.eb : k == 1 ? a.mul : a.add;
        const bool in = j0 + c < a.O;
        cp_async16(vs + k * kHC + c, in ? src + j0 + c : src, in);
      }
    }
    cp_async_commit();
  }

  __device__ __forceinline__ void start(const Args& a) {
    for (int i = 0; i < S - 1; ++i) load(a, i);
  }

  __device__ __forceinline__ const unsigned char* next(const Args& a) {
    cp_async_wait<S - 2>();
    __syncthreads();
    load(a, q + S - 1);
    return buf + (q++ % S) * bytes;
  }
};

// Warp (wm, wn) = (warp % 4, warp / 4): rows 16 wm.. of the block; hidden
// columns 32 wn.. of a chunk for h and dz; input columns wn kKp / 2.. for
// dx.
template <int S>
__global__ void __launch_bounds__(kThreads, 1) head_bwd_rows(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NP = a.NP, gld = NP + 8;
  const int M = a.M, C = a.C, O = a.O;
  const size_t E = 3 * (size_t)O + a.n;   // a block's column partials
  // Dynamic shared memory: the ring; the x tile [kBM][kLdW] (dx at the
  // end), the bf16(gy) tile [kBM][NP + 8], the chunk's dhc and z tiles
  // [kBM][kLdT] (bf16); the warps' column sums [4][3][kHC] (fp32). The
  // padded strides keep ldmatrix free of bank conflicts.
  Ring<S> ring{smem, stage_bytes(NP), 0, (O + kHC - 1) / kHC};
  bf16* xs = reinterpret_cast<bf16*>(smem + S * ring.bytes);
  bf16* gys = xs + kBM * kLdW;
  bf16* dht = gys + kBM * gld;
  bf16* zt = dht + kBM * kLdT;
  float* red = reinterpret_cast<float*>(zt + kBM * kLdT);
  // the plan's bytes (ops/head.py:bwd_plan) must hold this layout
  if (reinterpret_cast<unsigned char*>(red + 4 * 3 * kHC) - smem >
      dynamic_smem_bytes())
    __trap();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.x * kBM;
  const int c0w = wn * kCT * 8;     // the warp's first dx column
  float* cols = a.cols + blockIdx.x * E;

  // The block's x and gy rows are one contiguous, 16-byte aligned span
  // each (128 C and 128 n bytes a block): cp.async copies them as they lie
  // into the ring's last stage, free until the first next(), while the
  // first chunks stream in; then they are laid out as padded tiles, and
  // written out as padded rows for the weight-gradient products.
  const int rows = min(kBM, M - m0);
  {
    unsigned char* raw = smem + (S - 1) * ring.bytes;
    const size_t xb = (size_t)rows * C * 2, gb = (size_t)rows * a.n * 2;
    const unsigned char* xg =
        reinterpret_cast<const unsigned char*>(a.x + (size_t)m0 * C);
    const unsigned char* gg =
        reinterpret_cast<const unsigned char*>(a.gy + (size_t)m0 * a.n);
    for (int v = threadIdx.x; v < (int)(xb / 16); v += kThreads)
      cp_async16(raw + 16 * v, xg + 16 * v, true);
    for (int v = threadIdx.x; v < (int)(gb / 16); v += kThreads)
      cp_async16(raw + 128 * C + 16 * v, gg + 16 * v, true);
    cp_async_commit();
    // the ragged ends, at most 15 bytes each
    if (threadIdx.x < 2) {
      const size_t n = threadIdx.x ? gb : xb, off = threadIdx.x ? 128 * C : 0;
      const unsigned char* src = threadIdx.x ? gg : xg;
      for (size_t b = n / 16 * 16; b < n; b += 2)
        *reinterpret_cast<unsigned short*>(raw + off + b) =
            *reinterpret_cast<const unsigned short*>(src + b);
    }
  }
  ring.start(a);
  cp_async_wait<S - 1>();
  __syncthreads();
  {
    const unsigned char* raw = smem + (S - 1) * ring.bytes;
    const uint32_t* xr = reinterpret_cast<const uint32_t*>(raw);
    const bf16* gr = reinterpret_cast<const bf16*>(raw + 128 * C);
    uint32_t* xp = reinterpret_cast<uint32_t*>(a.xpad);
    uint32_t* x32 = reinterpret_cast<uint32_t*>(xs);
    const int kw = kKp / 2, cw = C / 2;
    const bf16 zero = __float2bfloat16(0.f);
    for (int r = warp; r < kBM; r += kWarps) {
      for (int w = lane; w < kw; w += 32) {
        const uint32_t val = (r < rows && w < cw) ? xr[r * cw + w] : 0u;
        x32[r * (kLdW / 2) + w] = val;
        if (r < rows) xp[(size_t)(m0 + r) * kw + w] = val;
      }
      for (int o = lane; o < NP; o += 32) {
        const bf16 val = (r < rows && o < a.n) ? gr[r * a.n + o] : zero;
        gys[r * gld + o] = val;
        if (r < rows && o < a.NG) a.gypad[(size_t)(m0 + r) * a.NG + o] = val;
      }
    }
  }

  float dxa[kCT][4];
  zero<kCT>(dxa);
  const bf16* pa = xs + (16 * wm + (lane & 15)) * kLdW + (lane >> 4) * 8;
  const bf16* ga = gys + (16 * wm + (lane & 15)) * gld + (lane >> 4) * 8;
  const bf16* da = dht + (16 * wm + (lane & 15)) * kLdT + (lane >> 4) * 8;
  for (int j0 = 0; j0 < O; j0 += kHC) {
    const bf16* ws = reinterpret_cast<const bf16*>(ring.next(a));
    const bf16* ps = ws + kHC * kLdW;
    const float* vs = reinterpret_cast<const float*>(ps + NP * kLdT);

    // ---- h = x We^T[j0..] and dz = bf16(gy) Wp^T[..j0] (16 x 32) --------
    float ha[4][4], dza[4][4];
    zero<4>(ha);
    zero<4>(dza);
    {
      const bf16* pb = ws + (32 * wn + (lane & 7) + ((lane >> 4) << 3)) * kLdW +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kKp; kk += 16) {
        uint32_t af[4], b0[4], b1[4];
        ldsm_x4(af, pa + kk);
        ldsm_x4(b0, pb + kk);
        ldsm_x4(b1, pb + 16 * kLdW + kk);
        mma_bf16_16816(ha[0], af, b0[0], b0[1]);
        mma_bf16_16816(ha[1], af, b0[2], b0[3]);
        mma_bf16_16816(ha[2], af, b1[0], b1[1]);
        mma_bf16_16816(ha[3], af, b1[2], b1[3]);
      }
      const bf16* pt = ps + (lane & 15) * kLdT + 32 * wn + (lane >> 4) * 8;
      for (int kk = 0; kk < NP; kk += 16) {
        uint32_t af[4], b0[4], b1[4];
        ldsm_x4(af, ga + kk);
        ldsm_x4_t(b0, pt + kk * kLdT);
        ldsm_x4_t(b1, pt + kk * kLdT + 16);
        mma_bf16_16816(dza[0], af, b0[0], b0[1]);
        mma_bf16_16816(dza[1], af, b0[2], b0[3]);
        mma_bf16_16816(dza[2], af, b1[0], b1[1]);
        mma_bf16_16816(dza[3], af, b1[2], b1[3]);
      }
    }

    // ---- ReLU mask, BN-affine backward: the dhc and z tiles; the warp's
    // column sums over its 16 rows -------------------------------------------
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 32 * wn + 8 * nt + 2 * t;
      float s[3][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ebj = vs[col + e], mf = vs[kHC + col + e];
        const float mb = round_bf16(mf), ab = round_bf16(vs[2 * kHC + col + e]);
        s[0][e] = s[1][e] = s[2][e] = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float hc = round_bf16(ha[nt][2 * half + e] + ebj);
          const float zp = round_bf16(round_bf16(hc * mb) + ab);
          const float dzp = zp > 0.f ? dza[nt][2 * half + e] : 0.f;
          const float dh = dzp * mf;
          ha[nt][2 * half + e] = fmaxf(zp, 0.f);   // z
          dza[nt][2 * half + e] = dh;
          s[0][e] += dh;
          s[1][e] += dzp * hc;
          s[2][e] += dzp;
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * wm + g + 8 * half;
        st_bf2(zt + r * kLdT + col, ha[nt][2 * half], ha[nt][2 * half + 1]);
        st_bf2(dht + r * kLdT + col, dza[nt][2 * half], dza[nt][2 * half + 1]);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = s[k][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) red[(3 * wm + k) * kHC + col + e] = v;
        }
    }
    __syncthreads();  // the dhc tile is whole

    // ---- dx += dhc We^T[j0..]^T ---------------------------------------------
#pragma unroll
    for (int kk = 0; kk < kHC; kk += 16) {
      uint32_t af[4];
      ldsm_x4(af, da + kk);
      const bf16* pb = ws + (kk + (lane & 15)) * kLdW + c0w + (lane >> 4) * 8;
#pragma unroll
      for (int i = 0; i < kCT; i += 2) {
        if (i + 1 < kCT) {
          uint32_t b[4];
          ldsm_x4_t(b, pb + 8 * i);
          mma_bf16_16816(dxa[i], af, b[0], b[1]);
          mma_bf16_16816(dxa[i + 1], af, b[2], b[3]);
        } else {
          uint32_t b[2];
          ldsm_x2_t(b, pb + 8 * i);
          mma_bf16_16816(dxa[i], af, b[0], b[1]);
        }
      }
    }

    // ---- the chunk's dhc and z rows (16-byte stores), its column sums ----
    for (int v = threadIdx.x; v < 2 * kBM * (kHC / 8); v += kThreads) {
      const int w = v / (kBM * (kHC / 8)), u = v - w * (kBM * (kHC / 8));
      const int r = u >> 3, c = (u & 7) * 8, m = m0 + r;
      if (m < M && j0 + c < O)
        *reinterpret_cast<uint4*>((w ? a.z : a.dhc) + (size_t)m * O + j0 + c) =
            *reinterpret_cast<const uint4*>((w ? zt : dht) + r * kLdT + c);
    }
    for (int v = threadIdx.x; v < 3 * kHC; v += kThreads) {
      const int k = v / kHC, j = v - k * kHC;
      if (j0 + j < O)
        cols[(size_t)k * O + j0 + j] =
            ((red[k * kHC + j] + red[(3 + k) * kHC + j]) +
             red[(6 + k) * kHC + j]) + red[(9 + k) * kHC + j];
    }
  }

  // ---- dbp's partial; dx through the x tile (last read before the final
  // chunk's second barrier), 4-byte coalesced stores ------------------------
  if (threadIdx.x < a.n) {
    float s = 0.f;
    for (int r = 0; r < kBM; ++r) s += __bfloat162float(gys[r * gld + threadIdx.x]);
    cols[3 * (size_t)O + threadIdx.x] = s;
  }
#pragma unroll
  for (int i = 0; i < kCT; ++i) {
    const int c = c0w + 8 * i + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      st_bf2(xs + (16 * wm + g + 8 * half) * kLdW + c, dxa[i][2 * half],
             dxa[i][2 * half + 1]);
  }
  __syncthreads();
  {
    const uint32_t* x32 = reinterpret_cast<const uint32_t*>(xs);
    uint32_t* dx = reinterpret_cast<uint32_t*>(a.dx);
    const int cw = C / 2;
    for (int v = threadIdx.x; v < kBM * cw; v += kThreads) {
      const int r = v / cw, w = v - r * cw;
      if (m0 + r < M) dx[(size_t)(m0 + r) * cw + w] = x32[r * (kLdW / 2) + w];
    }
  }
}

// We^T [O][C] -> [O][kKp], zeros past C.
__global__ void head_bwd_pad_kernel(const bf16* __restrict__ src, int rows,
                                    int C, bf16* __restrict__ dst) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * kKp) return;
  const int r = i / kKp, c = i - r * kKp;
  dst[i] = c < C ? src[(size_t)r * C + c] : __float2bfloat16(0.f);
}

// The summed weight gradients, fp32 [n1 + n2], to bf16 d1 [n1], d2 [n2].
__global__ void head_bwd_cast_kernel(const float* __restrict__ src, int n1,
                                     int n2, bf16* __restrict__ d1,
                                     bf16* __restrict__ d2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n1) d1[i] = __float2bfloat16(src[i]);
  else if (i < n1 + n2) d2[i - n1] = __float2bfloat16(src[i]);
}

template <int S>
cudaError_t launch_rows(const Args& a, int blocks, int smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      head_bwd_rows<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  head_bwd_rows<S><<<blocks, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

}  // namespace

// x [M, C], ek_t (We^T) [O, C], pk_t (Wp^T) [n, O] bf16; eb, mul, add [O]
// fp32; gy [M, n] bf16. stages, smem, sw and sp are the caller's launch
// plan (ops/head.py:bwd_plan). Scratch: wpad [O, 272], xpad [M, 272], gypad
// [M, ng], dhc and z [M, O] bf16; cols [ceil(M / 64), 3 O + n] and the
// weight-gradient partials part (sw stripes of [O, C] or sp of [n, O], one
// product at a time) fp32. Outputs: dx [M, C] bf16; sums fp32 [O C + n O
// + 3 O + n] (dWe^T, dWp^T, dbe, dmul, dadd, dbp); dek_t [O, C] and dpk_t
// [n, O] bf16.
extern "C" int mtlora_head_mlp_bwd(
    const void* x, const void* ek_t, const void* eb, const void* mul,
    const void* add, const void* pk_t, const void* gy, void* dx, void* wpad,
    void* xpad, void* gypad, void* dhc, void* z, void* cols, void* part,
    void* sums, void* dek_t, void* dpk_t, int M, int C, int O, int n, int ng,
    int stages, int smem, int sw, int sp, void* stream) {
  const int NP = (n + 15) / 16 * 16;
  if (M < 1 || C < 2 || (C & 1) || C > kKp || O < 8 || O % 8 || n < 1 ||
      n > kNMax || ng < n || ng % 8 || ng > NP || sw < 1 || sp < 1 ||
      !(stages == 3 || stages == 4))
    return (int)cudaErrorInvalidValue;
  // cp.async of x, gy, We^T, Wp^T and the vectors; 16-byte stores of the
  // tiles
  if (misaligned(x) || misaligned(gy) || misaligned(pk_t) ||
      misaligned(eb) || misaligned(mul) || misaligned(add) ||
      misaligned(wpad) || misaligned(dhc) || misaligned(z) ||
      misaligned(xpad) || misaligned(gypad) || (uintptr_t)dx % 4)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.wpad = static_cast<const bf16*>(wpad);
  a.pk_t = static_cast<const bf16*>(pk_t);
  a.gy = static_cast<const bf16*>(gy);
  a.eb = static_cast<const float*>(eb);
  a.mul = static_cast<const float*>(mul);
  a.add = static_cast<const float*>(add);
  a.dx = static_cast<bf16*>(dx);
  a.xpad = static_cast<bf16*>(xpad);
  a.gypad = static_cast<bf16*>(gypad);
  a.dhc = static_cast<bf16*>(dhc);
  a.z = static_cast<bf16*>(z);
  a.cols = static_cast<float*>(cols);
  a.M = M;
  a.C = C;
  a.O = O;
  a.n = n;
  a.NP = NP;
  a.NG = ng;

  head_bwd_pad_kernel<<<(O * kKp + 255) / 256, 256, 0, st>>>(
      static_cast<const bf16*>(ek_t), O, C, static_cast<bf16*>(wpad));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int blocks = (M + kBM - 1) / kBM;
  e = stages == 4 ? launch_rows<4>(a, blocks, smem, st)
                  : launch_rows<3>(a, blocks, smem, st);
  if (e != cudaSuccess) return (int)e;

  // dWe^T [O, C] = dhc^T x; dWp^T [n, O] = bf16(gy)^T z; the column sums
  float* pp = static_cast<float*>(part);
  float* out = static_cast<float*>(sums);
  const MatSrc dhs{a.dhc, O, 1.f, 0}, xs{a.xpad, kKp, 1.f, 0};
  const MatSrc gs{a.gypad, ng, 1.f, 0}, zs{a.z, O, 1.f, 0};
  e = wgrad(dhs, xs, M, O, C, sw, pp, out, st);
  if (e != cudaSuccess) return (int)e;
  e = wgrad(gs, zs, M, n, O, sp, pp, out + (size_t)O * C, st);
  if (e != cudaSuccess) return (int)e;
  e = sum_parts(a.cols, blocks, 3 * (size_t)O + n,
                out + (size_t)O * C + (size_t)n * O, st);
  if (e != cudaSuccess) return (int)e;
  head_bwd_cast_kernel<<<(O * C + n * O + 255) / 256, 256, 0, st>>>(
      out, O * C, n * O, static_cast<bf16*>(dek_t),
      static_cast<bf16*>(dpk_t));
  return (int)cudaGetLastError();
}
