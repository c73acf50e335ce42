// K1: dense single-level Lucas-Kanade.
//
// Replaces the TPU kernel optical_flow_tpu/kernels/lk_kernel.py::
// _lk_pallas_batched (pallas_call at :173; body _lk_band_kernel :46-88,
// tail lk_solve_tail :91-137).
//
// Bound on the H100: memory. Per output pixel it reads 2 and writes 2
// floats (16 B) and does about 80 flops, 5 flops per byte against the
// card's 67 TFLOP/s / 3.35 TB/s = 20; so 16 B/px at 3.35 TB/s is the floor
// (about 0.09 us for the 135^2 level of the main path, far below launch
// cost). Design: one thread per output pixel; the tile plus its 2-px halo
// is staged once in shared memory, the five gradient products are formed
// once per position in shared memory, and the window sums read them from
// there, so device memory sees each input about once.
#include "common.cuh"

namespace oft {

__global__ void lk_kernel(const float* __restrict__ img1, const float* __restrict__ img2,
                          float* __restrict__ u, float* __restrict__ v, int H, int W) {
  __shared__ float s1[SH * SW];
  __shared__ float s2[SH * SW];
  __shared__ float prod[5 * PH * PW];
  const size_t off = (size_t)blockIdx.z * H * W;
  const float* i1 = img1 + off;
  const float* i2 = img2 + off;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  for (int i = threadIdx.x; i < SH * SW; i += NT) {
    // REFLECT_101 at the top/left (-1 -> 1, -2 -> 2); rows and columns
    // past the end feed only masked outputs and read as 0.
    const int sy = y0 - 2 + i / SW, sx = x0 - 2 + i % SW;
    const int ry = sy < 0 ? -sy : sy, rx = sx < 0 ? -sx : sx;
    const bool in = ry < H && rx < W;
    s1[i] = in ? i1[ry * W + rx] : 0.0f;
    s2[i] = in ? i2[ry * W + rx] : 0.0f;
  }
  __syncthreads();
  lk_products(s1, s2, prod);
  __syncthreads();

  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy < H && gx < W) {
    float uu, vv;
    lk_solve(prod, ty, tx, gy, gx, H, W, &uu, &vv);
    u[off + gy * W + gx] = uu;
    v[off + gy * W + gx] = vv;
  }
}

}  // namespace oft

extern "C" int oft_lk(const float* img1, const float* img2, float* u, float* v, int B, int H,
                      int W, void* stream) {
  const dim3 grid((W + oft::TW - 1) / oft::TW, (H + oft::TH - 1) / oft::TH, B);
  oft::lk_kernel<<<grid, oft::NT, 0, (cudaStream_t)stream>>>(img1, img2, u, v, H, W);
  return (int)cudaGetLastError();
}
