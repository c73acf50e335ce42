// K3 and K4: the symmetric shift_sep warp fused with the LK solve.
//
// K4 (warp_lk_kernel<false>) replaces optical_flow_tpu/kernels/
// warp_lk_kernel.py::_warp_lk_batched (pallas_call at :370; body
// _warp_lk_kernel :179-249, core _warp_lk_core :252-321): clip the flow to
// +-clamp, scale by `half` (-0.5 for the convergent corrected-mode warp),
// quantize to the 1/32 grid within +-C, warp image 1 at +d and image 2 at
// -d with shared hat weights, REFLECT_101-extend the warped planes, and
// solve LK -> (du, dv).
//
// K3 (warp_lk_kernel<true>) replaces _pyrup_warp_lk_batched (pallas_call at
// :667; body _pyrup_warp_lk_kernel :458-592): the corrected inter-level
// step. It first forms up = 2 * pyrUp(coarse flow) (columns first, as
// ops/pyramid.pyr_up_cols_first, cv::pyrUp's asymmetric border, 0 outside
// the image), then runs K4's warp and solve with half = -0.5, and returns
// (du + up_u, dv + up_v).
//
// Bound on the H100: memory. K4 reads 4 and writes 2 floats per pixel
// (24 B; K3 reads a quarter-size coarse flow instead of the full one,
// about 18 B) for about 150 flops, 6-8 flops per byte against the card's
// balance of 20; at 3.35 TB/s a 1080^2 K3 call cannot beat about 6 us.
// Design: one thread per output pixel. The flow tile plus a C+3-row and
// 2-column halo is staged in shared memory (K3 computes its upsampled flow
// there, so the fine flow never goes to device memory), the warped planes
// are formed in shared memory with two taps per axis read through L1
// (floor of the quantized displacement and the next one: exactly the taps
// of the 2C+1-tap shift_sep sum that carry weight; each source row reads
// its own x-displacement), and the LK tail of lk.cu runs on them.
#include "common.cuh"

namespace oft {

// Fine-resolution value of 2 * pyr_up_cols_first(coarse) at (Y, X), with
// cv::pyrUp's asymmetric border on the coarse plane (-1 -> 1, n -> n-1).
__device__ __forceinline__ int pyrup_index(int i, int n) {
  if (i < 0) return n > 1 ? 1 : 0;
  return i >= n ? n - 1 : i;
}

__device__ __forceinline__ float up_cols(const float* c, int j, int n, int px, int Hc, int Wc) {
  const float* row = c + pyrup_index(j, Hc) * Wc;
  if (px == 0)
    return (0.125f * row[pyrup_index(n - 1, Wc)] + 0.75f * row[pyrup_index(n, Wc)]) +
           0.125f * row[pyrup_index(n + 1, Wc)];
  return 0.5f * row[pyrup_index(n, Wc)] + 0.5f * row[pyrup_index(n + 1, Wc)];
}

__device__ __forceinline__ float pyrup2(const float* c, int Y, int X, int Hc, int Wc) {
  const int m = Y >> 1, n = X >> 1, px = X & 1;
  float r;
  if ((Y & 1) == 0)
    r = (0.125f * up_cols(c, m - 1, n, px, Hc, Wc) + 0.75f * up_cols(c, m, n, px, Hc, Wc)) +
        0.125f * up_cols(c, m + 1, n, px, Hc, Wc);
  else
    r = 0.5f * up_cols(c, m, n, px, Hc, Wc) + 0.5f * up_cols(c, m + 1, n, px, Hc, Wc);
  return 2.0f * r;
}

// Shared memory: the flow tile FX/FY (FH x SW, rows from y0-C-3), the
// warped planes W1/W2 (SH x SW) and the five product planes (PH x PW).
__host__ __device__ inline int flow_rows(int C) { return TH + 2 * C + 5; }
__host__ inline size_t warp_lk_smem_bytes(int C) {
  return sizeof(float) * (2 * flow_rows(C) * SW + 2 * SH * SW + 5 * PH * PW);
}

template <bool PYRUP>
__global__ void warp_lk_kernel(const float* __restrict__ img1, const float* __restrict__ img2,
                               const float* __restrict__ fu, const float* __restrict__ fv,
                               float* __restrict__ ou, float* __restrict__ ov, int H, int W,
                               int C, float clamp, float half) {
  extern __shared__ float smem[];
  const int FH = flow_rows(C);
  float* FX = smem;
  float* FY = FX + FH * SW;
  float* W1 = FY + FH * SW;
  float* W2 = W1 + SH * SW;
  float* prod = W2 + SH * SW;

  const int b = blockIdx.z;
  const float* i1 = img1 + (size_t)b * H * W;
  const float* i2 = img2 + (size_t)b * H * W;
  const int Hc = H / 2, Wc = W / 2;
  const float* cu = fu + (size_t)b * (PYRUP ? Hc * Wc : H * W);
  const float* cv = fv + (size_t)b * (PYRUP ? Hc * Wc : H * W);
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int fy0 = y0 - C - 3, fx0 = x0 - 2;
  const float Cf = (float)C;

  // Phase 1: the flow tile (K4: the given flow; K3: the upsampled one).
  // Outside the image it is 0; it only ever meets 0-valued image rows there.
  for (int i = threadIdx.x; i < FH * SW; i += NT) {
    const int Y = fy0 + i / SW, X = fx0 + i % SW;
    float a = 0.0f, c = 0.0f;
    if (Y >= 0 && Y < H && X >= 0 && X < W) {
      if (PYRUP) {
        a = pyrup2(cu, Y, X, Hc, Wc);
        c = pyrup2(cv, Y, X, Hc, Wc);
      } else {
        a = cu[Y * W + X];
        c = cv[Y * W + X];
      }
    }
    FX[i] = a;
    FY[i] = c;
  }
  __syncthreads();

  // Phase 2: the warped planes on the staged grid. REFLECT_101 at the
  // top/left (-1 -> 1, -2 -> 2) is taken by warping at the reflected
  // position; positions past the bottom/right edge feed only masked
  // outputs and are 0.
  for (int i = threadIdx.x; i < SH * SW; i += NT) {
    const int sy = y0 - 2 + i / SW, sx = x0 - 2 + i % SW;
    const int ry = sy < 0 ? -sy : sy, rx = sx < 0 ? -sx : sx;
    float w1 = 0.0f, w2 = 0.0f;
    if (sy < H && sx < W && ry < H && rx < W) {
      const int col = rx - fx0;
      const float qy = quant_half(FY[(ry - fy0) * SW + col], clamp, half, Cf);
      const float kf = floorf(qy);
      const int k = (int)kf;
      const float f = qy - kf;
      // image 1 reads rows ry+k, ry+k+1; image 2 rows ry-k, ry-k-1; each
      // row's x-pass uses that row's own quantized x-displacement
      const int ra = ry + k, rb = ry + k + 1, rc = ry - k, rd = ry - k - 1;
      const float qa = (ra >= 0 && ra < H) ? quant_half(FX[(ra - fy0) * SW + col], clamp, half, Cf) : 0.0f;
      const float qb = (rb >= 0 && rb < H) ? quant_half(FX[(rb - fy0) * SW + col], clamp, half, Cf) : 0.0f;
      const float qc = (rc >= 0 && rc < H) ? quant_half(FX[(rc - fy0) * SW + col], clamp, half, Cf) : 0.0f;
      const float qd = (rd >= 0 && rd < H) ? quant_half(FX[(rd - fy0) * SW + col], clamp, half, Cf) : 0.0f;
      w1 = (1.0f - f) * shift_row(i1, qa, ra, rx, 1, H, W) + f * shift_row(i1, qb, rb, rx, 1, H, W);
      w2 = (1.0f - f) * shift_row(i2, qc, rc, rx, -1, H, W) + f * shift_row(i2, qd, rd, rx, -1, H, W);
    }
    W1[i] = w1;
    W2[i] = w2;
  }
  __syncthreads();
  lk_products(W1, W2, prod);
  __syncthreads();

  const int ty = threadIdx.x / TW, tx = threadIdx.x % TW;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy < H && gx < W) {
    float du, dv;
    lk_solve(prod, ty, tx, gy, gx, H, W, &du, &dv);
    if (PYRUP) {
      const int o = (ty + C + 3) * SW + tx + 2;
      du = du + FX[o];
      dv = dv + FY[o];
    }
    ou[(size_t)b * H * W + gy * W + gx] = du;
    ov[(size_t)b * H * W + gy * W + gx] = dv;
  }
}

template <bool PYRUP>
int launch_warp_lk(const float* img1, const float* img2, const float* fu, const float* fv,
                   float* ou, float* ov, int B, int H, int W, int C, float clamp, float half,
                   void* stream) {
  const size_t smem = warp_lk_smem_bytes(C);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_lk_kernel<PYRUP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  warp_lk_kernel<PYRUP><<<grid, NT, smem, (cudaStream_t)stream>>>(img1, img2, fu, fv, ou, ov, H,
                                                                  W, C, clamp, half);
  return (int)cudaGetLastError();
}

}  // namespace oft

extern "C" int oft_warp_lk(const float* img1, const float* img2, const float* u, const float* v,
                           float* du, float* dv, int B, int H, int W, int C, float clamp,
                           float half, void* stream) {
  return oft::launch_warp_lk<false>(img1, img2, u, v, du, dv, B, H, W, C, clamp, half, stream);
}

extern "C" int oft_pyrup_warp_lk(const float* img1, const float* img2, const float* uc,
                                 const float* vc, float* u, float* v, int B, int H, int W, int C,
                                 float clamp, void* stream) {
  return oft::launch_warp_lk<true>(img1, img2, uc, vc, u, v, B, H, W, C, clamp, -0.5f, stream);
}
