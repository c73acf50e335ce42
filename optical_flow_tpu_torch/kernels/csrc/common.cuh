// Device code shared by the port's kernels (lk.cu, pyrdown.cu, warp_lk.cu).
//
// Every kernel works on (B, H, W) float32 planes, one thread per output
// pixel over a TH x TW tile, with the tile and its halo staged in shared
// memory. The arithmetic follows the plain PyTorch versions operation for
// operation (same operands, same order), and the library is built with
// -fmad=false and without --use_fast_math, so each product and sum rounds
// as it does in eager PyTorch and '/' is the IEEE division.
#pragma once

#include <cuda_runtime.h>

namespace oft {

constexpr int TW = 32;  // output tile width: one warp per tile row
constexpr int TH = 8;   // output tile height
constexpr int NT = TW * TH;

// Staged image/warped planes cover rows [y0-2, y0+TH+1) and columns
// [x0-2, x0+TW+1): the 2x2 gradient stencil (anchor (1,1)) plus the 3x3
// window reach 2 up/left and 1 down/right of an output pixel.
constexpr int SH = TH + 3;
constexpr int SW = TW + 3;
// Gradient products cover rows [y0-1, y0+TH+1) and columns [x0-1, x0+TW+1).
constexpr int PH = TH + 2;
constexpr int PW = TW + 2;

// BORDER_REFLECT_101 source index (numpy 'reflect', repeated for reaches
// wider than the axis).
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - i;
}

// jnp.clip / torch.clamp: NaN propagates (fminf/fmaxf would drop it).
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Flow-space quantized half-displacement (ops/warp.quantize_disp applied
// to -clip(flow)/2): clip to the clamp, scale by `half` (+-0.5), clip to
// the tap reach C, round half to even onto the 1/32 grid. rintf rounds
// half to even like torch.round; roundf would round halves away from 0.
__device__ __forceinline__ float quant_half(float f, float clamp, float half, float C) {
  const float h = clipf(clipf(f, -clamp, clamp) * half, -C, C);
  return rintf(h * 32.0f) / 32.0f;
}

// 2x2 gradients of both staged planes -> the five products fx^2, fy^2,
// fx*fy, fx*ft, fy*ft at every gradient position of the tile.
// s1/s2: SH x SW planes; prod: 5 consecutive PH x PW planes.
__device__ __forceinline__ void lk_products(const float* s1, const float* s2, float* prod) {
  for (int i = threadIdx.x; i < PH * PW; i += NT) {
    const int gy = i / PW, gx = i % PW;
    const int o = gy * SW + gx;
    const float a1 = s1[o], b1 = s1[o + 1], c1 = s1[o + SW], d1 = s1[o + SW + 1];
    const float a2 = s2[o], b2 = s2[o + 1], c2 = s2[o + SW], d2 = s2[o + SW + 1];
    const float fx = (((b1 - a1) + d1) - c1) + (((b2 - a2) + d2) - c2);
    const float fy = (((c1 + d1) - a1) - b1) + (((c2 + d2) - a2) - b2);
    const float ft = (((a2 + b2) + c2) + d2) - (((a1 + b1) + c1) + d1);
    prod[0 * PH * PW + i] = fx * fx;
    prod[1 * PH * PW + i] = fy * fy;
    prod[2 * PH * PW + i] = fx * fy;
    prod[3 * PH * PW + i] = fx * ft;
    prod[4 * PH * PW + i] = fy * ft;
  }
}

// The LK tail at tile position (ty, tx), global (gy, gx) in an H x W frame:
// 3x3 window sums (rows first, then columns, as
// ops/window.sum3x3_interior), the Cramer solve with det == 0 -> 0
// (cv::divide), and the frame's 1-px ring zeroed.
__device__ __forceinline__ void lk_solve(const float* prod, int ty, int tx, int gy, int gx,
                                         int H, int W, float* u, float* v) {
  float s[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float* p = prod + k * PH * PW + ty * PW + tx;
    const float r0 = (p[0] + p[PW]) + p[2 * PW];
    const float r1 = (p[1] + p[PW + 1]) + p[2 * PW + 1];
    const float r2 = (p[2] + p[PW + 2]) + p[2 * PW + 2];
    s[k] = (r0 + r1) + r2;
  }
  const float det = s[0] * s[1] - s[2] * s[2];
  const bool ok = det != 0.0f;
  const float den = ok ? det : 1.0f;
  const float uu = (ok ? s[2] * s[4] - s[1] * s[3] : 0.0f) / den;
  const float vv = (ok ? s[3] * s[2] - s[0] * s[4] : 0.0f) / den;
  const bool keep = gy > 0 && gy < H - 1 && gx > 0 && gx < W - 1;
  *u = keep ? uu : 0.0f;
  *v = keep ? vv : 0.0f;
}

// One row of the separable symmetric warp: the x-pass value of `img` at
// row r, column c, for the quantized half-flow qx read at (r, c). sgn = +1
// samples at c + d (image 1), -1 at c - d (image 2). Only the two taps
// k0 = floor(qx) and k0 + 1 carry weight, so this equals the 2C+1-tap
// shift_sep sum exactly (the other taps add exact zeros). `img` points at
// pixel (0, 0) with row stride `ld`; the readable region is rows
// [lo, Hh) x columns [lo, Wh) (a full frame: lo = 0; a halo-extended tile:
// lo = -halo) and the source is 0 outside it.
__device__ __forceinline__ float shift_row(const float* img, int ld, float qx, int r, int c,
                                           int sgn, int lo, int Hh, int Wh) {
  if (r < lo || r >= Hh) return 0.0f;
  const float kf = floorf(qx);
  const int k = (int)kf;
  const float f = qx - kf;
  const int c0 = c + sgn * k, c1 = c + sgn * (k + 1);
  const float v0 = (c0 >= lo && c0 < Wh) ? img[r * ld + c0] : 0.0f;
  const float v1 = (c1 >= lo && c1 < Wh) ? img[r * ld + c1] : 0.0f;
  return (1.0f - f) * v0 + f * v1;
}

}  // namespace oft
