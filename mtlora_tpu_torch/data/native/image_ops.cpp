// Host-side image ops of the port's augmentation pipeline.
//
// The port's own copy of mtlora_tpu/data/native/image_ops.cpp, with the
// same arithmetic, so that its transforms are bit-equal to the JAX
// package's with that package's native backend switched on. It implements
// the cv2 kernels the transforms need -- resize (nearest / bilinear /
// bicubic), warpAffine and horizontal flip -- with OpenCV's semantics
// (half-pixel centers, bicubic with a = -0.75, clamped borders for resize,
// a constant 0 border for warpAffine); the port has no cv2.
//
// Exposed as a C ABI for ctypes (see __init__.py). float32, C-contiguous
// HxWxC with C in {1, 2, 3, 4}.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// OpenCV bicubic kernel (a = -0.75).
inline void cubic_coeffs(float t, float* w) {
  const float A = -0.75f;
  w[0] = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A;
  w[1] = ((A + 2) * t - (A + 3)) * t * t + 1;
  w[2] = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1;
  w[3] = 1.f - w[0] - w[1] - w[2];
}

enum Interp { NEAREST = 0, LINEAR = 1, CUBIC = 2 };

// Sample src at (fy, fx) with border clamp (resize) for all channels.
inline void sample(const float* src, int h, int w, int c, float fy,
                   float fx, int interp, float* out) {
  if (interp == NEAREST) {
    // cv2 resize nearest truncates toward zero after +0 offset
    int sy = clampi(static_cast<int>(std::floor(fy)), 0, h - 1);
    int sx = clampi(static_cast<int>(std::floor(fx)), 0, w - 1);
    const float* p = src + (static_cast<int64_t>(sy) * w + sx) * c;
    for (int k = 0; k < c; ++k) out[k] = p[k];
  } else if (interp == LINEAR) {
    int y0 = static_cast<int>(std::floor(fy));
    int x0 = static_cast<int>(std::floor(fx));
    float ty = fy - y0, tx = fx - x0;
    int y0c = clampi(y0, 0, h - 1), y1c = clampi(y0 + 1, 0, h - 1);
    int x0c = clampi(x0, 0, w - 1), x1c = clampi(x0 + 1, 0, w - 1);
    const float* p00 = src + (static_cast<int64_t>(y0c) * w + x0c) * c;
    const float* p01 = src + (static_cast<int64_t>(y0c) * w + x1c) * c;
    const float* p10 = src + (static_cast<int64_t>(y1c) * w + x0c) * c;
    const float* p11 = src + (static_cast<int64_t>(y1c) * w + x1c) * c;
    for (int k = 0; k < c; ++k) {
      float a = p00[k] + tx * (p01[k] - p00[k]);
      float b = p10[k] + tx * (p11[k] - p10[k]);
      out[k] = a + ty * (b - a);
    }
  } else {  // CUBIC
    int y0 = static_cast<int>(std::floor(fy));
    int x0 = static_cast<int>(std::floor(fx));
    float wy[4], wx[4];
    cubic_coeffs(fy - y0, wy);
    cubic_coeffs(fx - x0, wx);
    for (int k = 0; k < c; ++k) out[k] = 0.f;
    for (int i = 0; i < 4; ++i) {
      int yy = clampi(y0 - 1 + i, 0, h - 1);
      for (int j = 0; j < 4; ++j) {
        int xx = clampi(x0 - 1 + j, 0, w - 1);
        const float* p = src + (static_cast<int64_t>(yy) * w + xx) * c;
        float wgt = wy[i] * wx[j];
        for (int k = 0; k < c; ++k) out[k] += wgt * p[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// dst is dh x dw x c, src is sh x sw x c, both float32 C-contiguous.
void resize_f32(const float* src, int sh, int sw, int c, float* dst,
                int dh, int dw, int interp) {
  const double sy_ratio = static_cast<double>(sh) / dh;
  const double sx_ratio = static_cast<double>(sw) / dw;
  float px[8];
  for (int y = 0; y < dh; ++y) {
    for (int x = 0; x < dw; ++x) {
      float* o = dst + (static_cast<int64_t>(y) * dw + x) * c;
      if (interp == NEAREST) {
        // cv2 INTER_NEAREST: floor(x * ratio)
        int sy = clampi(static_cast<int>(y * sy_ratio), 0, sh - 1);
        int sx = clampi(static_cast<int>(x * sx_ratio), 0, sw - 1);
        const float* p = src + (static_cast<int64_t>(sy) * sw + sx) * c;
        for (int k = 0; k < c; ++k) o[k] = p[k];
      } else {
        // half-pixel centers
        float fy = static_cast<float>((y + 0.5) * sy_ratio - 0.5);
        float fx = static_cast<float>((x + 0.5) * sx_ratio - 0.5);
        sample(src, sh, sw, c, fy, fx, interp, px);
        for (int k = 0; k < c; ++k) o[k] = px[k];
      }
    }
  }
}

// warpAffine with forward matrix m (2x3, row-major), cv2 semantics:
// the matrix is inverted internally; out-of-range -> constant 0 border.
void warp_affine_f32(const float* src, int sh, int sw, int c, float* dst,
                     int dh, int dw, const double* m, int interp) {
  // invert [a b tx; d e ty]
  double a = m[0], b = m[1], tx = m[2];
  double d = m[3], e = m[4], ty = m[5];
  double det = a * e - b * d;
  double ia = e / det, ib = -b / det, id = -d / det, ie = a / det;
  double itx = -(ia * tx + ib * ty);
  double ity = -(id * tx + ie * ty);
  float px[8];
  for (int y = 0; y < dh; ++y) {
    for (int x = 0; x < dw; ++x) {
      double fx = ia * x + ib * y + itx;
      double fy = id * x + ie * y + ity;
      float* o = dst + (static_cast<int64_t>(y) * dw + x) * c;
      if (interp == NEAREST) {
        int sy = static_cast<int>(std::lround(fy));
        int sx = static_cast<int>(std::lround(fx));
        if (sy < 0 || sy >= sh || sx < 0 || sx >= sw) {
          for (int k = 0; k < c; ++k) o[k] = 0.f;
        } else {
          const float* p = src + (static_cast<int64_t>(sy) * sw + sx) * c;
          for (int k = 0; k < c; ++k) o[k] = p[k];
        }
      } else {
        // cv2 remap semantics: out-of-range taps read the constant-0
        // border (BORDER_CONSTANT), including partial overlap.
        int y0 = static_cast<int>(std::floor(fy));
        int x0 = static_cast<int>(std::floor(fx));
        float tyf = static_cast<float>(fy - y0);
        float txf = static_cast<float>(fx - x0);
        int taps = (interp == CUBIC) ? 4 : 2;
        int off = (interp == CUBIC) ? 1 : 0;
        float wy[4], wx[4];
        if (interp == CUBIC) {
          cubic_coeffs(tyf, wy);
          cubic_coeffs(txf, wx);
        } else {
          wy[0] = 1 - tyf; wy[1] = tyf;
          wx[0] = 1 - txf; wx[1] = txf;
        }
        for (int k = 0; k < c; ++k) o[k] = 0.f;
        for (int i = 0; i < taps; ++i) {
          int yy = y0 - off + i;
          if (yy < 0 || yy >= sh) continue;
          for (int j = 0; j < taps; ++j) {
            int xx = x0 - off + j;
            if (xx < 0 || xx >= sw) continue;
            float wgt = wy[i] * wx[j];
            const float* p =
                src + (static_cast<int64_t>(yy) * sw + xx) * c;
            for (int k = 0; k < c; ++k) o[k] += wgt * p[k];
          }
        }
      }
    }
  }
}

void hflip_f32(const float* src, int h, int w, int c, float* dst) {
  for (int y = 0; y < h; ++y) {
    const float* row = src + static_cast<int64_t>(y) * w * c;
    float* orow = dst + static_cast<int64_t>(y) * w * c;
    for (int x = 0; x < w; ++x) {
      const float* p = row + static_cast<int64_t>(w - 1 - x) * c;
      float* o = orow + static_cast<int64_t>(x) * c;
      for (int k = 0; k < c; ++k) o[k] = p[k];
    }
  }
}

}  // extern "C"
