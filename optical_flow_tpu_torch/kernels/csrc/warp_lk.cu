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
// Bound on the H100: memory by the byte count (K4 reads 4 and writes 2
// floats per pixel; K3 reads a quarter-size coarse flow instead of the full
// one; at 3.35 TB/s a 1080^2 K3 call cannot beat about 6 us). What holds the
// kernel back is the instructions it issues: about 130 operations and 8
// gathers per output, plus the staging of every input a block reads. The
// design spends each of them once where it can:
// - A block is 8 warps of 32 lanes over a WTH x 29 output tile; lane l owns
//   column l of the 32-column warped grid and each warp walks WR output
//   rows, so the vertical reach of the flow (2C+5 rows) and of the LK
//   stencil (3 rows) is small against the rows a block serves. WR is 8
//   (WTH = 64) where the grid still gives every SM three blocks or more,
//   else 4, so that small frames keep the SMs busy.
// - Every input is staged from device memory with cp.async: first the flow
//   (K4: u and v on the staged grid; K3: its coarse window, cv::pyrUp's
//   border applied by the source index), then both frame windows, the
//   reach of the warp (C+1 beyond the warped grid each way), 0 outside the
//   readable region. The frame copies overlap the flow work below, and the
//   gathers never leave shared memory.
// - K3 runs pyrUp's column pass once per coarse row and fine column, then
//   the row pass once per fine position: each upsampled value is formed
//   once. The flow is quantized once per position, into QX (the rows the
//   x-passes read) and QY (the warped rows); K3 keeps its column pass to
//   form the raw upsampled value again at each output for du + up.
// - The LK tail lives in registers: a lane forms its warped column row by
//   row, gets the right neighbour by a shuffle, keeps the gradient products
//   of its last three rows, and forms the 3x3 window sums in
//   sum3x3_interior's order (rows, then columns) with two more shuffles.
//   No warped or product plane is stored.
// Shared memory grows with C (about 55 KB for K3 at C = 4 and WR = 8, so
// four blocks share an SM); a C whose block does not fit is refused at
// launch. Every product and sum has the operands and order of the plain
// version (-fmad=false), so the result equals it bit for bit.
#include "common.cuh"

namespace oft {

// Where a launch's H x W output sits: its first pixel at (row0, col0) of a
// Hg x Wg frame, inputs extended by `halo` pixels (K3's coarse flow by
// `ocr` rows and 2 columns; ocr == 0: the coarse flow is the bare frame's
// and pyrUp's border is taken on the fly).
struct Tile {
  int row0, col0, Hg, Wg, halo, ocr;
};

// The tile of K3/K4/K5: WNW warps; a warp walks WR output rows (a template
// parameter, 4 or 8, chosen by the launcher), so a block covers WTH = WNW *
// WR output rows.
constexpr int WL = 32;         // lanes: one column of the warped grid each
constexpr int WTW = WL - 3;    // output columns of a block
constexpr int WNW = 8;         // warps of a block
constexpr int WNT = WNW * WL;  // threads of a block
constexpr int CW = WL / 2 + 3; // K3's coarse-window columns

// Shared memory of a block with WTH output rows for reach C, in floats: QX
// (FH x WL, rows from y0-C-3: every row an x-pass reads), QY (SH x WL, the
// warped rows [y0-2, y0+WTH+1)), the two frame windows (FH x IW, rows from
// y0-C-3, columns from x0-C-3), and K3's column pass of both planes (CH x
// WL each, coarse rows from floor(fy0/2)-1). K3's coarse window (2 x CH x
// CW) lies over QX/QY, which are written after it is read.
struct Smem {
  int FH, SH, IW, CH;
  __host__ __device__ Smem(int C, int WTH)
      : FH(WTH + 2 * C + 5), SH(WTH + 3), IW(WTW + 2 * C + 5), CH(FH / 2 + 3) {}
  __host__ __device__ int flow() const {
    return (FH + SH) * WL > 2 * CH * CW ? (FH + SH) * WL : 2 * CH * CW;
  }
  __host__ size_t bytes(bool pyrup) const {
    return sizeof(float) * (flow() + 2 * FH * IW + (pyrup ? 2 * CH * WL : 0));
  }
};

// Where K3's coarse flow value at coarse (row j, column n) lies in its
// plane, or -1 where it is 0. TILE is a compile-time choice.
template <bool TILE>
struct Coarse {
  int Hc, Wc, ocr;

  // cv::pyrUp's asymmetric border on the bare plane (-1 -> 1, n -> n-1).
  __device__ __forceinline__ static int border(int i, int n) {
    if (i < 0) return n > 1 ? 1 : 0;
    return i >= n ? n - 1 : i;
  }

  // TILE: the plane is (Hc + 2 ocr) x (Wc + 4), its border already applied;
  // 0 beyond it (those values feed only outputs outside the tile).
  __device__ __forceinline__ int index(int j, int n) const {
    if (!TILE) return border(j, Hc) * Wc + border(n, Wc);
    const int r = j + ocr, c = n + 2;
    return (r >= 0 && r < Hc + 2 * ocr && c >= 0 && c < Wc + 4) ? r * (Wc + 4) + c : -1;
  }
};

// pyr_up_cols_first's column pass at fine column parity px, centred on
// coarse column r[0] of a staged coarse row.
__device__ __forceinline__ float up_cols(const float* r, int px) {
  if (px == 0) return (0.125f * r[-1] + 0.75f * r[0]) + 0.125f * r[1];
  return 0.5f * r[0] + 0.5f * r[1];
}

// 2 * its row pass at fine row Y (parity py), centred on column-pass row
// p[0]; rows of the column pass are WL apart.
__device__ __forceinline__ float up_rows2(const float* p, int py) {
  float r;
  if (py == 0)
    r = (0.125f * p[-WL] + 0.75f * p[0]) + 0.125f * p[WL];
  else
    r = 0.5f * p[0] + 0.5f * p[WL];
  return 2.0f * r;
}

// One row of the separable symmetric warp from a staged frame window: the
// x-pass value around row[0], for the quantized half-flow q. sgn = +1
// samples at +d (image 1), -1 at -d (image 2). Only the two taps floor(q)
// and floor(q) + 1 carry weight, so this equals the 2C+1-tap shift_sep sum
// exactly (the other taps add exact zeros); the window holds 0 wherever
// the source is 0.
__device__ __forceinline__ float shift_win(const float* row, float q, int sgn) {
  const float kf = floorf(q);
  const int k = (int)kf;
  const float f = q - kf;
  return (1.0f - f) * row[sgn * k] + f * row[sgn * (k + 1)];
}

// Coordinates below are the output's own (pixel (0, 0) = the tile's first
// pixel); G* are global ones. TILE (K3 only): the coarse flow carries its
// halo.
template <bool PYRUP, bool TILE, int WR>
__global__ void __launch_bounds__(WNT)
    warp_lk_kernel(const float* __restrict__ img1, const float* __restrict__ img2,
                   const float* __restrict__ fu, const float* __restrict__ fv,
                   float* __restrict__ ou, float* __restrict__ ov, int H, int W, int C,
                   float clamp, float half, Tile t) {
  extern __shared__ float smem[];
  constexpr int WTH = WNW * WR;
  const Smem g(C, WTH);
  float* QX = smem;
  float* QY = QX + g.FH * WL;
  float* I1 = smem + g.flow();
  float* I2 = I1 + g.FH * g.IW;
  float* UC = I2 + g.FH * g.IW;  // K3 only
  float* VC = UC + g.CH * WL;

  // frames and K4's flow: (H + 2 halo) x (W + 2 halo) planes, readable on
  // rows [lo, Hh) x columns [lo, Wh)
  const int lo = -t.halo, Hh = H + t.halo, Wh = W + t.halo, ld = W + 2 * t.halo;
  const size_t plane = (size_t)(H + 2 * t.halo) * ld;
  const size_t org = (size_t)t.halo * ld + t.halo;
  const int b = blockIdx.z;
  const float* i1 = img1 + b * plane + org;
  const float* i2 = img2 + b * plane + org;
  const int y0 = blockIdx.y * WTH, x0 = blockIdx.x * WTW;
  const int fy0 = y0 - C - 3, sy0 = y0 - 2, fx0 = x0 - 2, ix0 = x0 - C - 3;
  const float Cf = (float)C;
  const int tid = threadIdx.x, warp = tid / WL, lane = tid % WL;

  // Phase 1: start every copy from device memory (cp.async), in two groups:
  // first the flow (K4: u and v on the staged grid, raw, into QX/QY; K3: the
  // coarse window with cv::pyrUp's border, into CU/CV, which lie over
  // QX/QY), then both frame windows. Staged values are 0 outside the frame
  // and outside the readable region (what shift_sep's zero padding reads).
  // Lane l takes column x0-2+l of the staged flow; each warp takes every
  // WNW-th row.
  const int X = fx0 + lane, GX = t.col0 + X;
  const bool col_in = GX >= 0 && GX < t.Wg;
  const auto row_in = [&](int Y) { return t.row0 + Y >= 0 && t.row0 + Y < t.Hg; };
  const int cy0 = (fy0 >> 1) - 1, cx0 = (fx0 >> 1) - 1;
  float* CU = smem;  // K3 only
  float* CV = CU + g.CH * CW;
  if (PYRUP) {
    const int Hc = H / 2, Wc = W / 2;
    const size_t cplane = t.ocr ? (size_t)(Hc + 2 * t.ocr) * (Wc + 4) : (size_t)Hc * Wc;
    const float* cu = fu + b * cplane;
    const float* cv = fv + b * cplane;
    const Coarse<TILE> at{Hc, Wc, t.ocr};
    for (int i = tid; i < g.CH * CW; i += WNT) {
      const int o = at.index(cy0 + i / CW, cx0 + i % CW);
      if (o >= 0) {
        cp_async_f32(CU + i, cu + o);
        cp_async_f32(CV + i, cv + o);
      } else {
        CU[i] = 0.0f;
        CV[i] = 0.0f;
      }
    }
  } else {
    const float* u = fu + b * plane + org + X;
    const float* v = fv + b * plane + org + X;
    const bool col_rd = col_in && X >= lo && X < Wh;
    const auto stage = [&](float* Q, const float* f, int Y) {
      if (col_rd && row_in(Y) && Y >= lo && Y < Hh)
        cp_async_f32(Q, f + Y * ld);
      else
        *Q = 0.0f;
    };
    for (int r = warp; r < g.FH; r += WNW) stage(QX + r * WL + lane, u, fy0 + r);
    for (int r = warp; r < g.SH; r += WNW) stage(QY + r * WL + lane, v, sy0 + r);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  {  // the flat index walked as (row, column): no element pays a division
    int r = tid / g.IW, c = tid % g.IW;
    const int dr = WNT / g.IW, dc = WNT % g.IW;
    for (int i = tid; i < g.FH * g.IW; i += WNT) {
      const int Y = fy0 + r, Xi = ix0 + c;
      if (Y >= lo && Y < Hh && Xi >= lo && Xi < Wh) {
        cp_async_f32(I1 + i, i1 + Y * ld + Xi);
        cp_async_f32(I2 + i, i2 + Y * ld + Xi);
      } else {
        I1[i] = 0.0f;
        I2[i] = 0.0f;
      }
      r += dr;
      c += dc;
      if (c >= g.IW) {
        c -= g.IW;
        ++r;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // Phase 2, while the frame windows arrive: the flow on the staged grid,
  // quantized once (QX on rows [y0-C-3, y0+WTH+C+2), QY on the warped rows).
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this thread's flow copies
  if (PYRUP) {
    __syncthreads();  // every thread's coarse copies
    const int o = (X >> 1) - cx0;
    for (int j = warp; j < g.CH; j += WNW) {
      UC[j * WL + lane] = up_cols(CU + j * CW + o, X & 1);
      VC[j * WL + lane] = up_cols(CV + j * CW + o, X & 1);
    }
    __syncthreads();  // CU/CV are dead: QX/QY overwrite them
    const auto up = [&](const float* P, int Y) {
      return col_in && row_in(Y) ? up_rows2(P + ((Y >> 1) - cy0) * WL + lane, Y & 1) : 0.0f;
    };
    for (int r = warp; r < g.FH; r += WNW)
      QX[r * WL + lane] = quant_half(up(UC, fy0 + r), clamp, half, Cf);
    for (int r = warp; r < g.SH; r += WNW)
      QY[r * WL + lane] = quant_half(up(VC, sy0 + r), clamp, half, Cf);
  } else {  // in place: each thread quantizes the values it copied
    for (int r = warp; r < g.FH; r += WNW) QX[r * WL + lane] = quant_half(QX[r * WL + lane], clamp, half, Cf);
    for (int r = warp; r < g.SH; r += WNW) QY[r * WL + lane] = quant_half(QY[r * WL + lane], clamp, half, Cf);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // Phase 3: each warp walks its WR output rows; lane l holds warped column
  // x0-2+l and outputs column x0+l (lanes below WTW).
  const int r0 = y0 + warp * WR;
  if (r0 >= H) return;  // the whole warp: its rows are past the frame
  const unsigned all = 0xffffffffu;

  // The warped planes at (sy, this lane's column). REFLECT_101 at the
  // frame's top/left (-1 -> 1, -2 -> 2) is taken by warping at the
  // reflected position; positions past its bottom/right edge feed only
  // masked outputs and are 0. Inside the frame, positions past the tile are
  // warped from the halo. The column's part is the same on every row.
  const int grx = GX < 0 ? -GX : GX;
  const bool col_ok = GX < t.Wg && grx < t.Wg;
  const int rx = grx - t.col0;
  const float* qx = QX + rx - fx0;
  const float* qy = QY + rx - fx0;
  const float* w1c = I1 + rx - ix0;
  const float* w2c = I2 + rx - ix0;
  const auto warped = [&](int sy, float* w) {
    const int GY = t.row0 + sy, gry = GY < 0 ? -GY : GY;
    w[0] = 0.0f;
    w[1] = 0.0f;
    if (col_ok && GY < t.Hg && gry < t.Hg) {
      const int ry = gry - t.row0;
      const float q = qy[(ry - sy0) * WL];
      const float kf = floorf(q);
      const int k = (int)kf;
      const float f = q - kf;
      // image 1 reads rows ry+k, ry+k+1; image 2 rows ry-k, ry-k-1 (window
      // and QX rows); each row's x-pass uses that row's own x-displacement
      const int ra = ry + k - fy0, rc = ry - k - fy0;
      const float* a = w1c + ra * g.IW;
      const float* c = w2c + rc * g.IW;
      w[0] = (1.0f - f) * shift_win(a, qx[ra * WL], 1) + f * shift_win(a + g.IW, qx[(ra + 1) * WL], 1);
      w[1] = (1.0f - f) * shift_win(c, qx[rc * WL], -1) + f * shift_win(c - g.IW, qx[(rc - 1) * WL], -1);
    }
  };
  // The gradient products of the row pair (up, its right neighbours upn)
  // over (dn, dnn).
  const auto products = [](const float* up, const float* upn, const float* dn, const float* dnn,
                           float* p) {
    lk_grad_products(up[0], upn[0], dn[0], dnn[0], up[1], upn[1], dn[1], dnn[1], p);
  };
  const auto right = [&](const float* w, float* wn) {
    wn[0] = __shfl_down_sync(all, w[0], 1);
    wn[1] = __shfl_down_sync(all, w[1], 1);
  };

  float up[2], upn[2], dn[2], dnn[2], P0[5], P1[5], P2[5];
  warped(r0 - 2, up);
  right(up, upn);
  warped(r0 - 1, dn);
  right(dn, dnn);
  products(up, upn, dn, dnn, P0);
  warped(r0, up);
  right(up, upn);
  products(dn, dnn, up, upn, P1);
  const int gx = x0 + lane;
  for (int y = r0; y < r0 + WR; ++y) {
    // up: warped row y; dn: row y + 1; P0, P1, P2: products of rows y-2, y-1, y
    warped(y + 1, dn);
    right(dn, dnn);
    products(up, upn, dn, dnn, P2);
    float s[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const float cs = (P0[k] + P1[k]) + P2[k];  // this column's three rows
      s[k] = (cs + __shfl_down_sync(all, cs, 1)) + __shfl_down_sync(all, cs, 2);
      P0[k] = P1[k];
      P1[k] = P2[k];
    }
    up[0] = dn[0];
    up[1] = dn[1];
    upn[0] = dnn[0];
    upn[1] = dnn[1];
    if (lane < WTW && y < H && gx < W) {
      float du, dv;
      lk_cramer(s, t.row0 + y, t.col0 + gx, t.Hg, t.Wg, &du, &dv);
      if (PYRUP) {
        const int o = ((y >> 1) - cy0) * WL + lane + 2;
        du = du + up_rows2(UC + o, y & 1);
        dv = dv + up_rows2(VC + o, y & 1);
      }
      ou[(size_t)b * H * W + (size_t)y * W + gx] = du;
      ov[(size_t)b * H * W + (size_t)y * W + gx] = dv;
    }
  }
}

template <bool PYRUP, bool TILE, int WR>
int launch_shape(const float* img1, const float* img2, const float* fu, const float* fv,
                 float* ou, float* ov, int B, int H, int W, int C, float clamp, float half, Tile t,
                 int smem_limit, void* stream) {
  constexpr int WTH = WNW * WR;
  const size_t smem = Smem(C, WTH).bytes(PYRUP);
  if (smem > (size_t)smem_limit) return (int)cudaErrorInvalidValue;  // C too large for one block
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_lk_kernel<PYRUP, TILE, WR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + WTW - 1) / WTW, (H + WTH - 1) / WTH, B);
  warp_lk_kernel<PYRUP, TILE, WR><<<grid, WNT, smem, (cudaStream_t)stream>>>(
      img1, img2, fu, fv, ou, ov, H, W, C, clamp, half, t);
  return (int)cudaGetLastError();
}

// Tall strips (WR = 8) spend the least per output, but a block then holds
// 64 rows; while such a grid would give the card fewer than three blocks
// per SM (a 540^2 frame gives 171 for 132 SMs), half-height strips (WR = 4)
// keep more SMs busy.
template <bool PYRUP, bool TILE>
int launch_warp_lk(const float* img1, const float* img2, const float* fu, const float* fv,
                   float* ou, float* ov, int B, int H, int W, int C, float clamp, float half,
                   Tile t, void* stream) {
  int dev = 0, smem_limit = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long tall = (long)((W + WTW - 1) / WTW) * ((H + 8 * WNW - 1) / (8 * WNW)) * B;
  if (tall >= 3L * sms)
    return launch_shape<PYRUP, TILE, 8>(img1, img2, fu, fv, ou, ov, B, H, W, C, clamp, half, t,
                                        smem_limit, stream);
  return launch_shape<PYRUP, TILE, 4>(img1, img2, fu, fv, ou, ov, B, H, W, C, clamp, half, t,
                                      smem_limit, stream);
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
