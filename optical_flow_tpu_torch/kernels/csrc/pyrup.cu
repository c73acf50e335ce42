// S1: cv::pyrUp of two planes (the flow's u and v) in one launch.
//
// Replaces the TPU kernel scripts/tpu_pyrup_poc.py::pyrup_pallas
// (pallas_call at :40, kernel :22): the zero-stuffed 2x upsample convolved
// with 2 * [1,4,6,4,1]/16 per axis, rows first, then columns, with
// cv::pyrUp's asymmetric border (index -1 -> 1, index n -> n-1). The
// output is exactly (2Hc, 2Wc). It is the reference-mode inter-level
// upsample of flow/pyramid_loop.py.
//
// Numerics: the sums and products are those of ops/pyramid.py's _up_rows
// then _up_cols, in the same order; with -fmad=false the kernel equals its
// plain version, ops.pyramid.pyr_up, bit for bit.
//
// Bound on the H100: memory. Per coarse pixel and plane it reads 4 B and
// writes 16 B for 24 flops (about 1 flop per byte, against the card's 20);
// for (u, v) at 540^2 -> 1080^2, 2.33 MB in and 9.33 MB out take at least
// 3.5 us at 3.35 TB/s. Design: one thread per coarse pixel writes its 2x2
// output quad as two float2 stores, one per output row, so the row and
// column interleave costs nothing: neighbouring threads store neighbouring
// 8-byte pairs. The border is computed from the indices, so no padded copy
// of the input is made. The thread's 3x3 coarse neighbourhood is read
// through the L1 cache; each coarse value is fetched from device memory
// about once.
#include <cuda_runtime.h>

namespace oft {

constexpr float U0 = 0.125f, U1 = 0.5f, U2 = 0.75f, U3 = 0.5f, U4 = 0.125f;
constexpr int UTW = 32, UTH = 8;

// cv::pyrUp's border: -1 -> 1 (0 when the axis has one sample), n -> n-1.
__device__ __forceinline__ int up_border(int i, int n) {
  if (i < 0) return n > 1 ? 1 : 0;
  return i >= n ? n - 1 : i;
}

__global__ void pyrup_kernel(const float* __restrict__ u, const float* __restrict__ v,
                             float* __restrict__ uo, float* __restrict__ vo, int B, int Hc,
                             int Wc) {
  const int c = blockIdx.x * UTW + threadIdx.x;
  const int r = blockIdx.y * UTH + threadIdx.y;
  if (r >= Hc || c >= Wc) return;
  const int plane = blockIdx.z;  // u planes [0, B), v planes [B, 2B)
  const bool is_v = plane >= B;
  const size_t in_off = (size_t)(is_v ? plane - B : plane) * Hc * Wc;
  const float* x = (is_v ? v : u) + in_off;
  float* y = (is_v ? vo : uo) + in_off * 4;

  const int rm = up_border(r - 1, Hc), rp = up_border(r + 1, Hc);
  const int cols[3] = {up_border(c - 1, Wc), c, up_border(c + 1, Wc)};
  // the row pass at the three columns the column pass reads:
  // even output row 2r and odd output row 2r+1 (_up_rows)
  float ev[3], od[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a = x[rm * Wc + cols[k]], b = x[r * Wc + cols[k]], d = x[rp * Wc + cols[k]];
    ev[k] = (U0 * a + U2 * b) + U4 * d;
    od[k] = U1 * b + U3 * d;
  }
  // the column pass (_up_cols): even column 2c and odd column 2c+1
  const float2 top = make_float2((U0 * ev[0] + U2 * ev[1]) + U4 * ev[2], U1 * ev[1] + U3 * ev[2]);
  const float2 bot = make_float2((U0 * od[0] + U2 * od[1]) + U4 * od[2], U1 * od[1] + U3 * od[2]);
  const size_t Wo = 2 * (size_t)Wc;
  reinterpret_cast<float2*>(y + (2 * (size_t)r) * Wo)[c] = top;
  reinterpret_cast<float2*>(y + (2 * (size_t)r + 1) * Wo)[c] = bot;
}

}  // namespace oft

extern "C" int oft_pyrup(const float* u, const float* v, float* uo, float* vo, int B, int Hc,
                         int Wc, void* stream) {
  const dim3 block(oft::UTW, oft::UTH);
  const dim3 grid((Wc + oft::UTW - 1) / oft::UTW, (Hc + oft::UTH - 1) / oft::UTH, 2 * B);
  oft::pyrup_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(u, v, uo, vo, B, Hc, Wc);
  return (int)cudaGetLastError();
}
