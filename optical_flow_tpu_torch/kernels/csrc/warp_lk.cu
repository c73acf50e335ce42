// K3 and K4: the symmetric shift_sep warp fused with the LK solve, and K5,
// their tile mode.
//
// K4 (warp_lk_kernel<false, false>) replaces optical_flow_tpu/kernels/
// warp_lk_kernel.py::_warp_lk_batched (pallas_call at :370; body
// _warp_lk_kernel :179-249, core _warp_lk_core :252-321): clip the flow to
// +-clamp, scale by `half` (-0.5 for the convergent corrected-mode warp),
// quantize to the 1/32 grid within +-C, warp image 1 at +d and image 2 at
// -d with shared hat weights, REFLECT_101-extend the warped planes, and
// solve LK -> (du, dv).
//
// K3 (warp_lk_kernel<true, *>) replaces _pyrup_warp_lk_batched (pallas_call at
// :667; body _pyrup_warp_lk_kernel :458-592): the corrected inter-level
// step. It first forms up = 2 * pyrUp(coarse flow) (columns first, as
// ops/pyramid.pyr_up_cols_first, cv::pyrUp's asymmetric border, 0 outside
// the image), then runs K4's warp and solve with half = -0.5, and returns
// (du + up_u, dv + up_v).
//
// K5, the tile mode of both (entry points oft_warp_lk_tile and
// oft_pyrup_warp_lk_tile), replaces the same two pallas_calls run with a
// halo, a global origin (scalar prefetch) and the global frame size
// (warp_lk_kernel.py:179-197, :328-338, :599-610), which the mesh-sharded
// path runs on each tile. The frames (and K4's flow) arrive extended by
// `halo` >= C + 2 pixels per side: neighbour data inside the frame, 0
// beyond it. K3's coarse flow arrives extended by `ocr` rows and 2 columns
// with cv::pyrUp's border already applied at the frame's edges
// (parallel/halo.py exchange_halo_pyrup), so no index is clamped at a tile
// edge. Everything that depends on the frame, namely the REFLECT_101 fix
// at its top/left edge, the 0 of the warped planes past its bottom/right
// edge, the 0 of the flow outside it and the interior mask, is decided on
// global coordinates, so a tile's output equals the full-frame kernel's
// over the same pixels bit for bit. The full frame is the tile with
// origin (0, 0), the frame's own size and no halo.
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
// its own x-displacement), and the LK tail of lk.cu runs on them. Reads
// that reach past the (extended) input read 0: the staged flow starts at
// row y0-C-3 and a warp tap reaches C+1 columns, one beyond a C+2 halo,
// and both carry weight 0 there.
#include "common.cuh"

namespace oft {

// Where a launch's H x W output sits: its first pixel at (row0, col0) of a
// Hg x Wg frame, inputs extended by `halo` pixels (K3's coarse flow by
// `ocr` rows and 2 columns; ocr == 0: the coarse flow is the bare frame's
// and pyrUp's border is taken on the fly).
struct Tile {
  int row0, col0, Hg, Wg, halo, ocr;
};

// The coarse flow plane of K3, read at coarse (row j, column n). TILE is a
// compile-time choice: every read is then a load followed by a select, so
// the nine loads of a fine value issue together (a runtime branch around
// each load serialized them and cost the full frame ~80%).
template <bool TILE>
struct Coarse {
  const float* p;
  int Hc, Wc, ocr;

  // cv::pyrUp's asymmetric border on the bare plane (-1 -> 1, n -> n-1).
  __device__ __forceinline__ static int border(int i, int n) {
    if (i < 0) return n > 1 ? 1 : 0;
    return i >= n ? n - 1 : i;
  }

  // TILE: the plane is (Hc + 2 ocr) x (Wc + 4), its border already applied;
  // 0 beyond it (those values feed only outputs outside the tile).
  __device__ __forceinline__ float at(int j, int n) const {
    if (!TILE) return p[border(j, Hc) * Wc + border(n, Wc)];
    const int r = j + ocr, c = n + 2, He = Hc + 2 * ocr, We = Wc + 4;
    const float x = p[min(max(r, 0), He - 1) * We + min(max(c, 0), We - 1)];
    return (r >= 0 && r < He && c >= 0 && c < We) ? x : 0.0f;
  }
};

// Fine-resolution value of 2 * pyr_up_cols_first(coarse) at (Y, X).
template <bool TILE>
__device__ __forceinline__ float up_cols(const Coarse<TILE>& c, int j, int n, int px) {
  if (px == 0) return (0.125f * c.at(j, n - 1) + 0.75f * c.at(j, n)) + 0.125f * c.at(j, n + 1);
  return 0.5f * c.at(j, n) + 0.5f * c.at(j, n + 1);
}

template <bool TILE>
__device__ __forceinline__ float pyrup2(const Coarse<TILE>& c, int Y, int X) {
  const int m = Y >> 1, n = X >> 1, px = X & 1;
  float r;
  if ((Y & 1) == 0)
    r = (0.125f * up_cols(c, m - 1, n, px) + 0.75f * up_cols(c, m, n, px)) +
        0.125f * up_cols(c, m + 1, n, px);
  else
    r = 0.5f * up_cols(c, m, n, px) + 0.5f * up_cols(c, m + 1, n, px);
  return 2.0f * r;
}

// Shared memory: the flow tile FX/FY (FH x SW, rows from y0-C-3), the
// warped planes W1/W2 (SH x SW) and the five product planes (PH x PW).
__host__ __device__ inline int flow_rows(int C) { return TH + 2 * C + 5; }
__host__ inline size_t warp_lk_smem_bytes(int C) {
  return sizeof(float) * (2 * flow_rows(C) * SW + 2 * SH * SW + 5 * PH * PW);
}

// Coordinates below are the output's own (pixel (0, 0) = the tile's first
// pixel); G* are global ones. TILE (K3 only): the coarse flow carries its
// halo.
template <bool PYRUP, bool TILE>
__global__ void warp_lk_kernel(const float* __restrict__ img1, const float* __restrict__ img2,
                               const float* __restrict__ fu, const float* __restrict__ fv,
                               float* __restrict__ ou, float* __restrict__ ov, int H, int W,
                               int C, float clamp, float half, Tile t) {
  extern __shared__ float smem[];
  const int FH = flow_rows(C);
  float* FX = smem;
  float* FY = FX + FH * SW;
  float* W1 = FY + FH * SW;
  float* W2 = W1 + SH * SW;
  float* prod = W2 + SH * SW;

  // frames and K4's flow: (H + 2 halo) x (W + 2 halo) planes, readable on
  // rows [lo, Hh) x columns [lo, Wh)
  const int lo = -t.halo, Hh = H + t.halo, Wh = W + t.halo, ld = W + 2 * t.halo;
  const size_t plane = (size_t)(H + 2 * t.halo) * ld;
  const size_t org = (size_t)t.halo * ld + t.halo;
  const int b = blockIdx.z;
  const float* i1 = img1 + b * plane + org;
  const float* i2 = img2 + b * plane + org;
  const int Hc = H / 2, Wc = W / 2;
  const size_t cplane = t.ocr ? (size_t)(Hc + 2 * t.ocr) * (Wc + 4) : (size_t)Hc * Wc;
  const Coarse<TILE> cu{fu + b * cplane, Hc, Wc, t.ocr}, cv{fv + b * cplane, Hc, Wc, t.ocr};
  const float* u = PYRUP ? nullptr : fu + b * plane + org;
  const float* v = PYRUP ? nullptr : fv + b * plane + org;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int fy0 = y0 - C - 3, fx0 = x0 - 2;
  const float Cf = (float)C;

  // Phase 1: the flow tile (K4: the given flow; K3: the upsampled one).
  // Outside the frame it is 0; it only ever meets 0-valued image rows there.
  for (int i = threadIdx.x; i < FH * SW; i += NT) {
    const int Y = fy0 + i / SW, X = fx0 + i % SW;
    const int GY = t.row0 + Y, GX = t.col0 + X;
    float a = 0.0f, c = 0.0f;
    if (GY >= 0 && GY < t.Hg && GX >= 0 && GX < t.Wg) {
      if (PYRUP) {
        a = pyrup2(cu, Y, X);
        c = pyrup2(cv, Y, X);
      } else if (Y >= lo && Y < Hh && X >= lo && X < Wh) {
        a = u[Y * ld + X];
        c = v[Y * ld + X];
      }
    }
    FX[i] = a;
    FY[i] = c;
  }
  __syncthreads();

  // Phase 2: the warped planes on the staged grid. REFLECT_101 at the
  // frame's top/left (-1 -> 1, -2 -> 2) is taken by warping at the
  // reflected position; positions past its bottom/right edge feed only
  // masked outputs and are 0. Inside the frame, positions past the tile
  // are warped from the halo.
  for (int i = threadIdx.x; i < SH * SW; i += NT) {
    const int sy = y0 - 2 + i / SW, sx = x0 - 2 + i % SW;
    const int GY = t.row0 + sy, GX = t.col0 + sx;
    const int gry = GY < 0 ? -GY : GY, grx = GX < 0 ? -GX : GX;
    float w1 = 0.0f, w2 = 0.0f;
    if (GY < t.Hg && GX < t.Wg && gry < t.Hg && grx < t.Wg) {
      const int ry = gry - t.row0, rx = grx - t.col0;
      const int col = rx - fx0;
      const float qy = quant_half(FY[(ry - fy0) * SW + col], clamp, half, Cf);
      const float kf = floorf(qy);
      const int k = (int)kf;
      const float f = qy - kf;
      // image 1 reads rows ry+k, ry+k+1; image 2 rows ry-k, ry-k-1; each
      // row's x-pass uses that row's own quantized x-displacement
      const int ra = ry + k, rb = ry + k + 1, rc = ry - k, rd = ry - k - 1;
      const float qa = (ra >= lo && ra < Hh) ? quant_half(FX[(ra - fy0) * SW + col], clamp, half, Cf) : 0.0f;
      const float qb = (rb >= lo && rb < Hh) ? quant_half(FX[(rb - fy0) * SW + col], clamp, half, Cf) : 0.0f;
      const float qc = (rc >= lo && rc < Hh) ? quant_half(FX[(rc - fy0) * SW + col], clamp, half, Cf) : 0.0f;
      const float qd = (rd >= lo && rd < Hh) ? quant_half(FX[(rd - fy0) * SW + col], clamp, half, Cf) : 0.0f;
      w1 = (1.0f - f) * shift_row(i1, ld, qa, ra, rx, 1, lo, Hh, Wh) +
           f * shift_row(i1, ld, qb, rb, rx, 1, lo, Hh, Wh);
      w2 = (1.0f - f) * shift_row(i2, ld, qc, rc, rx, -1, lo, Hh, Wh) +
           f * shift_row(i2, ld, qd, rd, rx, -1, lo, Hh, Wh);
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
    lk_solve(prod, ty, tx, t.row0 + gy, t.col0 + gx, t.Hg, t.Wg, &du, &dv);
    if (PYRUP) {
      const int o = (ty + C + 3) * SW + tx + 2;
      du = du + FX[o];
      dv = dv + FY[o];
    }
    ou[(size_t)b * H * W + gy * W + gx] = du;
    ov[(size_t)b * H * W + gy * W + gx] = dv;
  }
}

template <bool PYRUP, bool TILE>
int launch_warp_lk(const float* img1, const float* img2, const float* fu, const float* fv,
                   float* ou, float* ov, int B, int H, int W, int C, float clamp, float half,
                   Tile t, void* stream) {
  const size_t smem = warp_lk_smem_bytes(C);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_lk_kernel<PYRUP, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  warp_lk_kernel<PYRUP, TILE><<<grid, NT, smem, (cudaStream_t)stream>>>(img1, img2, fu, fv, ou, ov,
                                                                        H, W, C, clamp, half, t);
  return (int)cudaGetLastError();
}

}  // namespace oft

extern "C" int oft_warp_lk(const float* img1, const float* img2, const float* u, const float* v,
                           float* du, float* dv, int B, int H, int W, int C, float clamp,
                           float half, void* stream) {
  return oft::launch_warp_lk<false, false>(img1, img2, u, v, du, dv, B, H, W, C, clamp, half,
                                           oft::Tile{0, 0, H, W, 0, 0}, stream);
}

extern "C" int oft_pyrup_warp_lk(const float* img1, const float* img2, const float* uc,
                                 const float* vc, float* u, float* v, int B, int H, int W, int C,
                                 float clamp, void* stream) {
  return oft::launch_warp_lk<true, false>(img1, img2, uc, vc, u, v, B, H, W, C, clamp, -0.5f,
                                          oft::Tile{0, 0, H, W, 0, 0}, stream);
}

// K5: H x W is the tile; the inputs are (H + 2 halo) x (W + 2 halo).
extern "C" int oft_warp_lk_tile(const float* img1, const float* img2, const float* u,
                                const float* v, float* du, float* dv, int B, int H, int W, int C,
                                float clamp, float half, int halo, int row0, int col0, int Hg,
                                int Wg, void* stream) {
  return oft::launch_warp_lk<false, false>(img1, img2, u, v, du, dv, B, H, W, C, clamp, half,
                                           oft::Tile{row0, col0, Hg, Wg, halo, 0}, stream);
}

// K5: the coarse flow is (H/2 + 2 ocr) x (W/2 + 4).
extern "C" int oft_pyrup_warp_lk_tile(const float* img1, const float* img2, const float* uc,
                                      const float* vc, float* u, float* v, int B, int H, int W,
                                      int C, float clamp, int halo, int ocr, int row0, int col0,
                                      int Hg, int Wg, void* stream) {
  return oft::launch_warp_lk<true, true>(img1, img2, uc, vc, u, v, B, H, W, C, clamp, -0.5f,
                                         oft::Tile{row0, col0, Hg, Wg, halo, ocr}, stream);
}
