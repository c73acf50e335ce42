// K2: cv::pyrDown, 5-tap [1,4,6,4,1]/16 with BORDER_REFLECT_101 and
// ceil-half decimation.
//
// Replaces the TPU kernel optical_flow_tpu/kernels/pyrdown_kernel.py::
// _pyrdown_pallas_batched (pallas_call at :146; body :61-109). The TPU
// kernel's column pass is an MXU matmul; this one keeps the plain 'poly'
// order instead (ops/pyramid.py): the vertical 5-tap at the kept rows
// first, then the horizontal one, each summed k0..k4.
//
// Bound on the H100: memory. Each output reads 4 inputs' worth of bytes and
// writes 1 float (20 B) for about 20 flops, 1 flop per byte, far below the
// card's 20 flops/byte balance; at 3.35 TB/s a 1080^2 -> 540^2 call cannot
// beat about 1.7 us. Design: one thread per output pixel; the input slab of
// a tile (2*TH+3 rows x 2*TW+3 columns, reflect indices computed in the
// kernel so every H, W >= 1 is taken) is read once into shared memory, the
// row pass is kept in shared memory, and only the decimated output is
// written.
#include "common.cuh"

namespace oft {

constexpr float K0 = 0.0625f, K1 = 0.25f, K2 = 0.375f, K3 = 0.25f, K4 = 0.0625f;
constexpr int DH = 2 * TH + 3;  // staged input rows
constexpr int DW = 2 * TW + 3;  // staged input columns

__global__ void pyrdown_kernel(const float* __restrict__ x, float* __restrict__ y, int H, int W,
                               int Ho, int Wo) {
  __shared__ float slab[DH * DW];
  __shared__ float srow[TH * DW];
  const float* xb = x + (size_t)blockIdx.z * H * W;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  for (int i = threadIdx.x; i < DH * DW; i += NT) {
    const int ry = reflect101(2 * y0 - 2 + i / DW, H);
    const int rx = reflect101(2 * x0 - 2 + i % DW, W);
    slab[i] = xb[ry * W + rx];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TH * DW; i += NT) {
    const int r = i / DW, c = i % DW;
    const float* p = slab + 2 * r * DW + c;
    srow[i] = (((K0 * p[0] + K1 * p[DW]) + K2 * p[2 * DW]) + K3 * p[3 * DW]) + K4 * p[4 * DW];
  }
  __syncthreads();

  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const int oy = y0 + ty, ox = x0 + tx;
  if (oy < Ho && ox < Wo) {
    const float* p = srow + ty * DW + 2 * tx;
    y[(size_t)blockIdx.z * Ho * Wo + oy * Wo + ox] =
        (((K0 * p[0] + K1 * p[1]) + K2 * p[2]) + K3 * p[3]) + K4 * p[4];
  }
}

}  // namespace oft

extern "C" int oft_pyrdown(const float* x, float* y, int B, int H, int W, void* stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 grid((Wo + oft::TW - 1) / oft::TW, (Ho + oft::TH - 1) / oft::TH, B);
  oft::pyrdown_kernel<<<grid, oft::NT, 0, (cudaStream_t)stream>>>(x, y, H, W, Ho, Wo);
  return (int)cudaGetLastError();
}
