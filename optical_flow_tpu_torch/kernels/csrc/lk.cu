// K1: dense single-level Lucas-Kanade.
//
// Replaces the TPU kernel optical_flow_tpu/kernels/lk_kernel.py::
// _lk_pallas_batched (pallas_call at :173; body _lk_band_kernel :46-88,
// tail lk_solve_tail :91-137): 2x2 gradients of two frames (REFLECT_101 at
// the top/left edge), the five products, 3x3 window sums, the Cramer solve
// with det == 0 -> 0, and the frame's 1-px ring zeroed.
//
// Bound on the H100: memory. Per output pixel it reads 2 floats and writes
// 2 (16 B) for 77 operations, about 5 per byte against the card's 20
// (67 TFLOP/s / 3.35 TB/s): 18.66 MB at 1080^2, 5.57 us at 3.35 TB/s; 0.087
// us at 135^2, far below the cost of a launch.
//
// What held the first design back (one thread per output of an 8 x 32 tile):
// it staged 11 x 35 of each frame in shared memory with 4-byte loads and an
// integer divide per element, stored five product planes there (1,700
// stores per 256 outputs) and read 45 values back per output, in three
// phases between barriers. This design keeps everything in registers:
// - A warp owns a strip of R rows; lane l holds CPL frame columns (1 or
//   2), x0-2+CPL*l onwards, so a warp serves 29 or 60 output columns. It
//   first loads its columns of both frames at all R+3 rows the strip reads
//   (y0-2 .. y0+R), so every load of the strip is in flight at once, each
//   row one coalesced warp load (8 bytes a lane where two columns sit in
//   8-byte aligned rows). Then it walks the rows: the column right of its
//   last comes from the next lane by a shuffle, the five gradient products
//   of its columns' last three rows stay in registers (P0, P1, P2), and each
//   output's 3x3 window is three columns' three-row sums, two of them taken
//   from the next lanes by shuffles. No shared memory, no barrier.
// - The strip's shape follows the grid (lk_strip_shape), as A/B timing on
//   the card chose it. Small frames (135^2 - 540^2) take 2 rows of one
//   column a lane: the time there is the chain of one warp, and more,
//   shorter warps win over the halo rows they reread. The 1080^2 frame
//   takes 4 rows of two columns a lane: the instructions issued rule there,
//   and two columns a lane halve the shuffles an output costs, read 64/60
//   rather than 32/29 of the columns and give each row two independent
//   chains. Taller strips were slower at every size: fewer warps, more
//   registers each, and a tail of blocks past the first wave.
// - A warp whose strip and columns lie inside the frame reads with plain
//   indices and solves without the ring's test. Only a warp at an edge
//   takes the REFLECT_101 index (-1 -> 1, -2 -> 2), the 0 past the
//   bottom/right edge (those values feed only the zeroed ring) and the
//   ring, and it solves only the columns inside the frame (see the solve).
//
// Bit for bit with the plain version: the products are lk_grad_products,
// the window is summed as sum3x3_interior sums it (the three rows of a
// column, (p0 + p1) + p2, then the three columns, (c0 + c1) + c2), and the
// solve is lk_cramer; -fmad=false and IEEE '/'.
#include <stdint.h>

#include "common.cuh"

namespace oft {
namespace {

constexpr int KL = 32;  // lanes
constexpr int KNW = 4;  // warps of a block, stacked down the frame

// Output columns of a warp whose lanes hold CPL frame columns each: an
// output reads frame columns x-2 .. x+1, so the last three of the warp's
// 32 CPL columns serve no output; a multiple of CPL, so that x0 keeps the
// lanes' columns aligned.
template <int CPL>
__host__ __device__ constexpr int lk_cols() {
  return (KL * CPL - 3) / CPL * CPL;
}

// One warp's strip: outputs at rows [y0, y0+R) x columns [x0, x0+KW) of an
// H x W plane; lane l holds frame columns X0+c = x0-2+CPL*l+c, c < CPL.
// EDGE: the strip or its reach leaves the frame. VEC (CPL == 2, inside
// only): 8-byte loads and stores (W even, planes 8-byte aligned).
template <int R, int CPL, bool EDGE, bool VEC>
__device__ __forceinline__ void lk_strip(const float* __restrict__ i1,
                                         const float* __restrict__ i2, float* __restrict__ u,
                                         float* __restrict__ v, int H, int W, int y0, int x0,
                                         int lane) {
  constexpr int N = R + 3;  // frame rows y0-2 .. y0+R
  constexpr int KW = lk_cols<CPL>();
  const int X0 = x0 - 2 + CPL * lane;
  float a[N][CPL], b[N][CPL];  // frame 1, frame 2
  if (EDGE) {
    int rx[CPL];
    bool in[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      rx[c] = X0 + c < 0 ? -(X0 + c) : X0 + c;
      in[c] = rx[c] < W;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int Y = y0 - 2 + k, ry = Y < 0 ? -Y : Y;
      const size_t row = ry < H ? (size_t)ry * W : 0;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const bool ok = in[c] && ry < H;
        a[k][c] = ok ? i1[row + rx[c]] : 0.0f;
        b[k][c] = ok ? i2[row + rx[c]] : 0.0f;
      }
    }
  } else {
    const float* p1 = i1 + (size_t)(y0 - 2) * W + X0;
    const float* p2 = i2 + (size_t)(y0 - 2) * W + X0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if constexpr (VEC) {
        const float2 f1 = __ldg(reinterpret_cast<const float2*>(p1 + (size_t)k * W));
        const float2 f2 = __ldg(reinterpret_cast<const float2*>(p2 + (size_t)k * W));
        a[k][0] = f1.x;
        a[k][1] = f1.y;
        b[k][0] = f2.x;
        b[k][1] = f2.y;
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          a[k][c] = __ldg(p1 + (size_t)k * W + c);
          b[k][c] = __ldg(p2 + (size_t)k * W + c);
        }
      }
    }
  }

  const unsigned all = 0xffffffffu;
  const int x = x0 + CPL * lane;  // the lane's first output column
  // frame column X0+CPL of each row: the next lane's first column
  float an = __shfl_down_sync(all, a[0][0], 1), bn = __shfl_down_sync(all, b[0][0], 1);
  float P0[CPL][5], P1[CPL][5], P2[CPL][5];  // products at columns X0 .. X0+CPL-1
#pragma unroll
  for (int k = 0; k + 1 < N; ++k) {
    // the products of frame rows (y0-2+k, y0-1+k): gradient row y0-1+k
    const float an1 = __shfl_down_sync(all, a[k + 1][0], 1);
    const float bn1 = __shfl_down_sync(all, b[k + 1][0], 1);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      // column c+1: the lane's own, or the next lane's first
      const bool own = c + 1 < CPL;
      const int cn = own ? c + 1 : c;
      lk_grad_products(a[k][c], own ? a[k][cn] : an, a[k + 1][c], own ? a[k + 1][cn] : an1,
                       b[k][c], own ? b[k][cn] : bn, b[k + 1][c], own ? b[k + 1][cn] : bn1, P2[c]);
    }
    an = an1;
    bn = bn1;
    if (k >= 2) {  // output row y0+k-2: products of rows k-2 (P0), k-1 (P1), k (P2)
      float s[CPL][5];
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        // the three-row sums of columns X0 .. X0+CPL+1 (the last two from
        // the next lanes), then the three-column window of each output
        float cs[CPL + 2];
#pragma unroll
        for (int c = 0; c < CPL; ++c) cs[c] = (P0[c][q] + P1[c][q]) + P2[c][q];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          cs[CPL + j] = __shfl_down_sync(all, cs[(CPL + j) % CPL], (CPL + j) / CPL);
#pragma unroll
        for (int c = 0; c < CPL; ++c) s[c][q] = (cs[c] + cs[c + 1]) + cs[c + 2];
      }
      const int y = y0 + k - 2;
      // Only columns inside the frame are solved: past its right edge the
      // window sums are whatever the lanes hold, and a division on them can
      // take the IEEE division's slow path, which the whole warp then waits
      // for (on the card that slowed small frames measurably).
      if (CPL * lane < KW && (!EDGE || (y < H && x < W))) {
        float* uo = u + (size_t)y * W + x;
        float* vo = v + (size_t)y * W + x;
        if constexpr (VEC) {  // inside: off the 1-px ring
          float u0, v0, u1, v1;
          lk_solve2x2(s[0], &u0, &v0);
          lk_solve2x2(s[1], &u1, &v1);
          *reinterpret_cast<float2*>(uo) = make_float2(u0, u1);
          *reinterpret_cast<float2*>(vo) = make_float2(v0, v1);
        } else {
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            if (!EDGE || x + c < W) {
              if (EDGE)
                lk_cramer(s[c], y, x + c, H, W, &uo[c], &vo[c]);
              else  // off the 1-px ring
                lk_solve2x2(s[c], &uo[c], &vo[c]);
            }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        P0[c][q] = P1[c][q];
        P1[c][q] = P2[c][q];
      }
  }
}

template <int R, int CPL, bool VEC>
__global__ void __launch_bounds__(KNW * KL)
    lk_strip_kernel(const float* __restrict__ img1, const float* __restrict__ img2,
                    float* __restrict__ u, float* __restrict__ v, int H, int W) {
  const int warp = threadIdx.x / KL, lane = threadIdx.x % KL;
  const int y0 = (blockIdx.y * KNW + warp) * R, x0 = blockIdx.x * lk_cols<CPL>();
  if (y0 >= H) return;  // the whole warp
  const size_t off = (size_t)blockIdx.z * H * W;
  // rows y0-2 .. y0+R and columns x0-2 .. x0+KL*CPL-3 inside the frame
  const bool inside = y0 >= 2 && y0 + R < H && x0 >= 2 && x0 + KL * CPL - 3 < W;
  if (inside)
    lk_strip<R, CPL, false, VEC>(img1 + off, img2 + off, u + off, v + off, H, W, y0, x0, lane);
  else
    lk_strip<R, CPL, true, false>(img1 + off, img2 + off, u + off, v + off, H, W, y0, x0, lane);
}

template <int R, int CPL>
int launch_strips(const float* img1, const float* img2, float* u, float* v, int B, int H, int W,
                  void* stream) {
  const dim3 grid((W + lk_cols<CPL>() - 1) / lk_cols<CPL>(), (H + R * KNW - 1) / (R * KNW), B);
  // 8-byte accesses (two columns a lane): every row starts 8-byte aligned
  // in 8-byte aligned planes
  const bool vec = CPL == 2 && W % 2 == 0 &&
                   ((uintptr_t)img1 | (uintptr_t)img2 | (uintptr_t)u | (uintptr_t)v) % 8 == 0;
  if (vec)
    lk_strip_kernel<R, CPL, CPL == 2><<<grid, KNW * KL, 0, (cudaStream_t)stream>>>(img1, img2, u, v,
                                                                                   H, W);
  else
    lk_strip_kernel<R, CPL, false><<<grid, KNW * KL, 0, (cudaStream_t)stream>>>(img1, img2, u, v,
                                                                               H, W);
  return (int)cudaGetLastError();
}

// The strip: 4 rows of two columns a lane where the grid of 2-row,
// one-column strips would give every SM at least LK_WARPS_PER_SM warps (a
// 1080^2 frame), else 2 rows of one column a lane (135^2 - 540^2): small
// frames gain from the shorter chain of each warp, large ones from the
// halved shuffles and the two independent chains of each row.
constexpr int LK_WARPS_PER_SM = 64;

bool lk_big_strips(int B, int H, int W, int sms) {
  const long warps = (long)((W + lk_cols<1>() - 1) / lk_cols<1>()) * ((H + 1) / 2) * B;
  return warps >= (long)LK_WARPS_PER_SM * sms;
}

}  // namespace
}  // namespace oft

extern "C" int oft_lk(const float* img1, const float* img2, float* u, float* v, int B, int H,
                      int W, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (oft::lk_big_strips(B, H, W, sms))
    return oft::launch_strips<4, 2>(img1, img2, u, v, B, H, W, stream);
  return oft::launch_strips<2, 1>(img1, img2, u, v, B, H, W, stream);
}
