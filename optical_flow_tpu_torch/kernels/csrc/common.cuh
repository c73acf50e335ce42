// Device code shared by the port's kernels (lk.cu, pyrdown.cu, warp_lk.cu):
// the REFLECT_101 index, cp.async copies, the flow quantization and the LK
// tail's gradient products and Cramer solve.
//
// The arithmetic follows the plain PyTorch versions operation for operation
// (same operands, same order), and the library is built with -fmad=false
// and without --use_fast_math, so each product and sum rounds as it does in
// eager PyTorch and '/' is the IEEE division.
#pragma once

#include <cuda_runtime.h>

namespace oft {

// BORDER_REFLECT_101 source index (numpy 'reflect', repeated for reaches
// wider than the axis).
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i %= p;
  if (i < 0) i += p;
  return i < n ? i : p - i;
}

// Asynchronous copies from device memory into shared memory (cp.async): 4
// bytes through the L1, or 16 bytes (both addresses 16-byte aligned) past it.
// A thread's copies are complete after cp_async_wait_all; other threads see
// them after the barrier that follows.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// The five products fx^2, fy^2, fx*fy, fx*ft, fy*ft of the 2x2 gradients at
// one position: (a, b) the upper row of each plane, (c, d) the lower one.
__device__ __forceinline__ void lk_grad_products(float a1, float b1, float c1, float d1, float a2,
                                                 float b2, float c2, float d2, float* p) {
  const float fx = (((b1 - a1) + d1) - c1) + (((b2 - a2) + d2) - c2);
  const float fy = (((c1 + d1) - a1) - b1) + (((c2 + d2) - a2) - b2);
  const float ft = (((a2 + b2) + c2) + d2) - (((a1 + b1) + c1) + d1);
  p[0] = fx * fx;
  p[1] = fy * fy;
  p[2] = fx * fy;
  p[3] = fx * ft;
  p[4] = fy * ft;
}

// The Cramer solve of the five window sums s, det == 0 -> 0 (cv::divide).
__device__ __forceinline__ void lk_solve2x2(const float* s, float* u, float* v) {
  const float det = s[0] * s[1] - s[2] * s[2];
  const bool ok = det != 0.0f;
  const float den = ok ? det : 1.0f;
  *u = (ok ? s[2] * s[4] - s[1] * s[3] : 0.0f) / den;
  *v = (ok ? s[3] * s[2] - s[0] * s[4] : 0.0f) / den;
}

// lk_solve2x2 at global (gy, gx) in an H x W frame, the frame's 1-px ring
// zeroed.
__device__ __forceinline__ void lk_cramer(const float* s, int gy, int gx, int H, int W, float* u,
                                          float* v) {
  float uu, vv;
  lk_solve2x2(s, &uu, &vv);
  const bool keep = gy > 0 && gy < H - 1 && gx > 0 && gx < W - 1;
  *u = keep ? uu : 0.0f;
  *v = keep ? vv : 0.0f;
}

}  // namespace oft
