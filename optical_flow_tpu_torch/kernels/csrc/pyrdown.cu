// K2: cv::pyrDown, 5-tap [1,4,6,4,1]/16 with BORDER_REFLECT_101 and
// ceil-half decimation, every level of a Gaussian pyramid from one host call.
//
// Replaces the TPU kernel optical_flow_tpu/kernels/pyrdown_kernel.py::
// _pyrdown_pallas_batched (:122-163, pallas_call at :146; body :61-109). The
// TPU kernel's column pass is an MXU matmul; this one keeps the plain 'poly'
// order instead (ops/pyramid.pyr_down_poly): the vertical 5-tap at the kept
// rows first, then the horizontal one, each summed k0..k4. With -fmad=false
// every output is bit-identical to the plain version.
//
// Bound on the H100: bytes. The input is read once and every level below
// it written once, 27 operations per output against 4-5 floats moved (about
// 1.3 per byte, far below the card's 20 per byte): a 1080^2 plane with 4
// levels moves 6.20 MB, 1.85 us at 3.35 TB/s (reading levels 1 and 2 back,
// as this design does, is not needed by the function: 7.66 MB, 2.29 us);
// one level 1080^2 -> 540^2 moves 5.83 MB, 1.74 us.
//
// Design, against what held the first version of this kernel back:
// 1. One host call per pyramid (oft_pyramid): one grid per level, issued
//    back to back from that call with programmatic dependent launch. A
//    level's grid may be scheduled while the level above it still runs; it
//    waits (griddepcontrol.wait) for that grid and its writes before reading,
//    and lets the next level's grid in as soon as it starts. So the host pays
//    one call and one allocation, and a level reads the one above it mostly
//    from the L2. A refused launch returns its error (no other path). A
//    persistent cooperative kernel with a grid-wide barrier between levels
//    read slower on the card (PERF.md, section 6). oft_pyrdown, the single
//    level, is the same kernel.
// 2. Tiles of 8 x 60 outputs for 256 threads (was 8 x 32, one output per
//    thread): the vertical pass takes 4 output rows down one column per
//    thread, so the 11 staged rows they need are read once for 4 sums (20
//    reads before), and its 2 x 125 columns give every thread one item; the
//    horizontal pass writes 2 outputs per thread, 60 to a row. 60 columns
//    keep the staged column start (2*x0-4) a multiple of 4 and divide the
//    540 outputs of a 1080 row exactly; 8 rows rather than 16 give the
//    540^2 and 270^2 levels 170 and 51 blocks, which read faster on the card.
// 3. A tile decides once whether its slab (19 rows x 128 columns) lies
//    inside the plane. Inside, it stages with plain index arithmetic; on the
//    border with the cheap reflect (-i, 2n-2-i, then a clamp for the
//    columns no kept output reads) for planes of 3 px and more, and the
//    general reflect101 only below 3 px (the 2 x 1 and 1 x 1 tail of a
//    pyramid).
// 4. Inside tiles of a plane whose rows start 16-byte aligned (W % 4 == 0)
//    stage with 16-byte cp.async (2-3 per thread, one round trip); the others
//    with 4-byte cp.async (the 270^2 level of a 1080^2 pyramid: W = 270).
#include <stdint.h>

#include "common.cuh"

namespace oft {
namespace {

constexpr float K0 = 0.0625f, K1 = 0.25f, K2 = 0.375f, K3 = 0.25f, K4 = 0.0625f;
constexpr int PNT = 256;                 // threads per block
constexpr int OH = 8, OW = 60;           // output tile
constexpr int RG = 4;                    // output rows per thread, vertical pass
constexpr int SR = 2 * OH + 3;           // staged input rows: 2*y0-2 .. 2*y0+2*OH
constexpr int VC = 2 * OW + 5;           // vertical-pass columns: 2*x0-2 .. 2*x0+2*OW+2
constexpr int SC = (VC + 2 + 3) / 4 * 4;  // staged columns from 2*x0-4, a multiple of 4
constexpr int HG = PNT / OW;             // row groups of the horizontal pass
static_assert(VC * (OH / RG) <= PNT, "one vertical-pass item per thread");
static_assert(OH % HG == 0 && (2 * OW) % 4 == 0, "tile shape");

// One level: (B, H, W) src -> (B, Ho, Wo) dst, `tiles` tiles a plane.
struct Level {
  const float* src;
  float* dst;
  int H, W, Ho, Wo, tiles_x, tiles;
  bool vec;  // rows start 16-byte aligned: 16-byte copies inside the plane
};

// The source index of i on a border tile; exact for every index a kept
// output reads (-2 .. n+1) once n >= 3.
__device__ __forceinline__ int edge(int i, int n) {
  if (n < 3) return reflect101(i, n);
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return min(max(i, 0), n - 1);
}

// The 5-tap at p[0..4], summed k0..k4 as _poly_pass sums its terms.
__device__ __forceinline__ float tap5(const float* p) {
  return (((K0 * p[0] + K1 * p[1]) + K2 * p[2]) + K3 * p[3]) + K4 * p[4];
}

__device__ __forceinline__ void level_tile(const Level& L, int t, float* slab, float* vsum) {
  const int plane = t / L.tiles;
  t -= plane * L.tiles;
  const int ty = t / L.tiles_x;
  const int y0 = ty * OH, x0 = (t - ty * L.tiles_x) * OW;
  const int H = L.H, W = L.W;
  const float* src = L.src + (size_t)plane * H * W;
  const int r0 = 2 * y0 - 2, c0 = 2 * x0 - 4;

  const bool inside = r0 >= 0 && r0 + SR <= H && c0 >= 0 && c0 + SC <= W;
  if (inside && L.vec) {
    for (int i = threadIdx.x; i < SR * (SC / 4); i += PNT) {
      const int r = i / (SC / 4), q = i - r * (SC / 4);
      cp_async_16(slab + r * SC + 4 * q, src + (size_t)(r0 + r) * W + c0 + 4 * q);
    }
  } else if (inside) {
    for (int i = threadIdx.x; i < SR * SC; i += PNT) {
      const int r = i / SC, c = i - r * SC;
      cp_async_f32(slab + i, src + (size_t)(r0 + r) * W + c0 + c);
    }
  } else {
    for (int i = threadIdx.x; i < SR * SC; i += PNT) {
      const int r = i / SC, c = i - r * SC;
      cp_async_f32(slab + i, src + (size_t)edge(r0 + r, H) * W + edge(c0 + c, W));
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // vertical 5-tap at the kept rows: RG outputs down slab column c + 2
  if (threadIdx.x < VC * (OH / RG)) {
    const int g = threadIdx.x / VC, c = threadIdx.x - g * VC;
    const float* p = slab + 2 * RG * g * SC + c + 2;
    float v[2 * RG + 3];
#pragma unroll
    for (int k = 0; k < 2 * RG + 3; ++k) v[k] = p[k * SC];
#pragma unroll
    for (int j = 0; j < RG; ++j) vsum[(RG * g + j) * VC + c] = tap5(v + 2 * j);
  }
  __syncthreads();

  // horizontal 5-tap at the kept columns: OH / HG outputs down one column
  if (threadIdx.x < HG * OW) {
    const int g = threadIdx.x / OW, tx = threadIdx.x - g * OW;
    const int ox = x0 + tx;
    if (ox < L.Wo) {
      float* dst = L.dst + (size_t)plane * L.Ho * L.Wo + ox;
#pragma unroll
      for (int j = 0; j < OH / HG; ++j) {
        const int r = g * (OH / HG) + j;
        if (y0 + r < L.Ho) dst[(size_t)(y0 + r) * L.Wo] = tap5(vsum + r * VC + 2 * tx);
      }
    }
  }
}

// One tile a block. Programmatic dependent launch: the grid may start while
// the previous kernel in the stream still runs, so it waits for that kernel
// (and its writes) before touching memory, then lets the next level start.
__global__ void __launch_bounds__(PNT) pyrdown_kernel(const Level L) {
  __shared__ __align__(16) float slab[SR * SC];
  __shared__ float vsum[OH * VC];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  level_tile(L, blockIdx.x, slab, vsum);
}

int launch_pyramid(const float* x, float* out, const long long* offsets, int B, int H, int W,
                   int levels, void* stream) {
  if (levels < 2) return 0;
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(PNT);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const float* src = x;
  for (int l = 1; l < levels; ++l) {
    Level L;
    L.src = src;
    L.dst = out + offsets[l - 1];
    L.H = H;
    L.W = W;
    L.Ho = (H + 1) / 2;
    L.Wo = (W + 1) / 2;
    L.tiles_x = (L.Wo + OW - 1) / OW;
    L.tiles = L.tiles_x * ((L.Ho + OH - 1) / OH);
    L.vec = W % 4 == 0 && (uintptr_t)src % 16 == 0;
    const long long blocks = (long long)L.tiles * B;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cfg.gridDim = dim3((unsigned)blocks);
    const cudaError_t e = cudaLaunchKernelEx(&cfg, pyrdown_kernel, L);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it: the caller raises, later launches are not blamed
      return (int)e;
    }
    src = L.dst;
    H = L.Ho;
    W = L.Wo;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace oft

// Levels 1 .. levels-1 of the pyramid of the (B, H, W) plane x, into out:
// level l starts offsets[l-1] floats into out (the caller's layout,
// kernels/pyrdown_kernel.py::level_layout); one call, one grid a level.
extern "C" int oft_pyramid(const float* x, float* out, const long long* offsets, int B, int H,
                           int W, int levels, void* stream) {
  return oft::launch_pyramid(x, out, offsets, B, H, W, levels, stream);
}

// One level down: (B, H, W) x -> (B, ceil(H/2), ceil(W/2)) y.
extern "C" int oft_pyrdown(const float* x, float* y, int B, int H, int W, void* stream) {
  const long long at_start = 0;
  return oft::launch_pyramid(x, y, &at_start, B, H, W, 2, stream);
}
